"""Datasets and client partitions of the port (seeded numpy, bit-equal)."""
from repro_torch.data.partition import (
    dirichlet_partition, equal_partition, server_split,
)
from repro_torch.data.synthetic import DatasetSpec, make_eurosat, make_statlog
from repro_torch.data.tokens import lm_batches, synthetic_corpus

__all__ = ["DatasetSpec", "make_eurosat", "make_statlog",
           "dirichlet_partition", "equal_partition", "server_split",
           "synthetic_corpus", "lm_batches"]
