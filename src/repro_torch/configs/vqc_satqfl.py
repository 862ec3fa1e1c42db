"""vqc-satqfl [vqc] — the paper's own quantum workload (sat-QFL §IV).

A variational quantum classifier: angle encoding of PCA-reduced features
onto n qubits, layered RY/RZ + CZ-entangling ansatz, Z-expectation
readout per class. Sized for the Statlog dataset (36 features reduced to
n_qubits, 7 classes) as in the paper's Qiskit experiments. The same
numbers as ``repro/configs/vqc_satqfl.py``.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="vqc-satqfl",
    family="vqc",
    n_layers=3,            # ansatz depth
    d_model=0,
    vocab_size=0,
    vqc_qubits=8,
    vqc_layers=3,
    n_features=8,          # post-PCA feature dim (angle encoding)
    n_classes=7,
    dtype="float32",
)
