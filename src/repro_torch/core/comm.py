"""Communication-time model for sat-QFL rounds (paper Fig. 12 / Table IV);
a copy of ``repro.core.comm``.

A transfer's wall time = link setup + serialized bytes / effective bandwidth
+ propagation latency. Effective ISL bandwidth is shared among concurrent
transfers on the same link budget (which is what makes the *simultaneous*
schedule pay for its parallelism), the sequential chain pays serialized
hops, and the asynchronous schedule pays window-waiting time. Security adds
QKD key-establishment time (finite key rate — Liao et al. report kHz-scale
sifted rates from LEO) and, for teleportation, classical-channel round trips
per qubit batch.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class CommModel:
    isl_bandwidth_bps: float = 200e6      # optical ISL, conservative
    feeder_bandwidth_bps: float = 500e6   # sat->ground feeder
    setup_s: float = 0.08                 # per-transfer link/session setup
    isl_latency_s: float = 0.004          # ~1200 km / c
    feeder_latency_s: float = 0.003
    window_wait_s: float = 18.0           # mean wait for an access window
    qkd_rate_bps: float = 1100.0          # sifted key rate (kHz-scale)
    teleport_batch_s: float = 0.012       # classical RTT per teleported batch
    enc_throughput_Bps: float = 2e9       # OTP XOR+MAC throughput

    def isl_transfer(self, nbytes: int, concurrent: int = 1) -> float:
        bw = self.isl_bandwidth_bps / max(concurrent, 1)
        return self.setup_s + nbytes * 8.0 / bw + self.isl_latency_s

    def feeder_transfer(self, nbytes: int, concurrent: int = 1) -> float:
        bw = self.feeder_bandwidth_bps / max(concurrent, 1)
        return self.setup_s + nbytes * 8.0 / bw + self.feeder_latency_s

    def qkd_time(self, n_bits: int) -> float:
        return n_bits / self.qkd_rate_bps

    def crypto_time(self, nbytes: int) -> float:
        return nbytes / self.enc_throughput_Bps

    def teleport_time(self, n_pairs: int) -> float:
        return n_pairs * self.teleport_batch_s


@dataclass
class CommLog:
    """Accumulates per-round communication/security costs.

    Individual link transfers are *counted* (``count_transfer``) as they
    happen, but their wall time is aggregated per round (parallel groups
    overlap) and recorded once via ``add_wall`` — so ``n_transfers`` counts
    real link uses, never wall-clock bookkeeping records.
    """
    transfer_s: float = 0.0
    wait_s: float = 0.0
    security_s: float = 0.0
    bytes_moved: int = 0
    n_transfers: int = 0
    per_round: list = field(default_factory=list)
    # per-round component deltas (wall / wait / security / bytes /
    # transfers), recorded by close_round — the async property suite
    # compares execution paths on these EXACTLY, component by component
    round_details: list = field(default_factory=list)

    def count_transfer(self, nbytes: int):
        self.bytes_moved += nbytes
        self.n_transfers += 1

    def add_wall(self, seconds: float):
        self.transfer_s += seconds

    def add_wait(self, seconds: float):
        self.wait_s += seconds

    def add_security(self, seconds: float):
        self.security_s += seconds

    def close_round(self, faults: dict | None = None):
        self.per_round.append(self.total_s)
        prev = (self.round_details[-1]["cum"] if self.round_details
                else (0.0, 0.0, 0.0, 0, 0))
        cum = (self.transfer_s, self.wait_s, self.security_s,
               self.bytes_moved, self.n_transfers)
        detail = {
            "transfer_s": cum[0] - prev[0],
            "wait_s": cum[1] - prev[1],
            "security_s": cum[2] - prev[2],
            "bytes_moved": cum[3] - prev[3],
            "n_transfers": cum[4] - prev[4],
            "cum": cum,
        }
        if faults is not None:
            # present ONLY when a fault plane is active, so fault-free
            # round details stay byte-identical to the pre-fault format
            detail["faults"] = faults
        self.round_details.append(detail)

    @property
    def total_s(self) -> float:
        return self.transfer_s + self.wait_s + self.security_s
