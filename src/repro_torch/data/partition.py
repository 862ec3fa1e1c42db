"""Client data partitioning (port of ``repro.data.partition``): 90% of
the data spread over the satellites, 10% held at the server. The index
draws are the JAX package's seeded numpy draws, so splits are bit-equal."""
from __future__ import annotations

import numpy as np
import torch


def _take(x: torch.Tensor, idx) -> torch.Tensor:
    return x[torch.as_tensor(np.asarray(idx, np.int64), device=x.device)]


def server_split(features, labels, server_frac: float = 0.1, seed: int = 0):
    """-> (client_features, client_labels, server_data dict with val/test)."""
    n = features.shape[0]
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_srv = int(n * server_frac)
    srv, cli = perm[:n_srv], perm[n_srv:]
    half = n_srv // 2
    server = {
        "val": {"features": _take(features, srv[:half]),
                "labels": _take(labels, srv[:half])},
        "test": {"features": _take(features, srv[half:]),
                 "labels": _take(labels, srv[half:])},
    }
    return _take(features, cli), _take(labels, cli), server


def equal_partition(features, labels, n_clients: int, seed: int = 0):
    """IID equal split; every client gets the same sample count (truncated)."""
    n = features.shape[0]
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    per = n // n_clients
    return [{"features": _take(features, perm[i * per:(i + 1) * per]),
             "labels": _take(labels, perm[i * per:(i + 1) * per])}
            for i in range(n_clients)]


def dirichlet_partition(features, labels, n_clients: int, alpha: float = 0.5,
                        seed: int = 0, min_per_client: int = 8):
    """Non-IID label-skew split (Dirichlet over class proportions); every
    client is tiled/truncated to the median size."""
    labels_np = labels.cpu().numpy()
    n_classes = int(labels_np.max()) + 1
    rng = np.random.default_rng(seed)
    idx_by_class = [np.where(labels_np == c)[0] for c in range(n_classes)]
    for idx in idx_by_class:
        rng.shuffle(idx)
    client_idx = [[] for _ in range(n_clients)]
    for c, idx in enumerate(idx_by_class):
        props = rng.dirichlet([alpha] * n_clients)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for cl, part in enumerate(np.split(idx, cuts)):
            client_idx[cl].extend(part.tolist())
    sizes = [max(len(ci), min_per_client) for ci in client_idx]
    target = int(np.median(sizes))
    out = []
    for ci in client_idx:
        ci = np.array(ci if ci else rng.integers(0, len(labels_np), 1))
        ci = np.tile(ci, int(np.ceil(target / len(ci))))[:target]
        out.append({"features": _take(features, ci),
                    "labels": _take(labels, ci)})
    return out
