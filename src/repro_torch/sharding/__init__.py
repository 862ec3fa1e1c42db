"""Sharding: the distribution context and the per-leaf specs (port of
``repro.sharding``)."""
from repro_torch.sharding.context import DistCtx  # noqa: F401
