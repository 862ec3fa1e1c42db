"""sat-QFL run configuration (a copy of ``repro.core.flconfig``).

Every field and every ``__post_init__`` rejection of the JAX package is
kept, so a config is valid in the port exactly when it is valid there,
and ``dataclasses.asdict`` of a config is the same dict in both packages
(a round checkpoint's fingerprint).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class SatQFLConfig:
    # --- schedule (paper Algorithm 1) --------------------------------------
    mode: str = "sim"            # qfl | sim | seq | async
    n_rounds: int = 20
    local_steps: int = 10        # SGD steps per satellite per round
    batch_size: int = 32
    lr: float = 0.05
    optimizer: str = "sgd"       # sgd | momentum | adamw
    lr_schedule: str = "inv_sqrt"  # constant | inv_sqrt (Proposition 1)
    grad_method: str = "autodiff"  # autodiff | param_shift (paper-faithful
    #   hardware gradient rule — needs the model's ModelApi.shift_grad)
    shift_chunk: int = 0         # param_shift: branch-stack chunk (0 = full)

    # --- topology constraints (paper §I-B) ---------------------------------
    h_max: int = 1               # ISL hops for secondary->main delivery
    l_max_s: float = 0.25
    max_staleness: int = 3       # Δ_max rounds (Assumption 1)

    # --- security (paper Algorithm 2) --------------------------------------
    security: str = "none"       # none | qkd | qkd_fernet | teleport
    qkd_bits: int = 512
    teleport_pairs: int = 16     # (θ,φ) pairs teleported per exchange
    verify_mac: bool = True
    on_qber_abort: str = "raise"  # raise | drop — a compromised edge kills
    #   the round (legacy) or just drops its update (paper §III-B: the
    #   satellite leaves C(t) until re-keyed); aborts surface per edge
    agg_security: str = "none"   # none | secagg — secagg adds Bonawitz-style
    #   pairwise masking to the async staleness buffer: cohort members mask
    #   their quantized updates with signed pad streams keyed off pairwise
    #   BB84 shares, and a satellite that QBER-aborts or misses its window
    #   has its pads cancelled exactly from the surviving rows (async only)

    # --- aggregation -------------------------------------------------------
    weight_by_samples: bool = True   # FedAvg weighting w_i
    main_trains: bool = True         # "Further train with main satellites"

    # --- fault injection & recovery (LEO availability model) ---------------
    # All rates default to 0.0, which compiles a FaultSchedule identical
    # to no schedule at all — the fault plane is bit-invisible until a
    # knob is turned. Sites are drawn from the shared seeded mixers
    # (security/keys.py), so the per-client oracle and the batched
    # executor inject at EXACTLY the same (round, edge/sat) sites.
    link_flap_rate: float = 0.0      # P[edge transmission drops], per attempt
    crash_rate: float = 0.0          # P[sat payload computer down], per round
    straggler_rate: float = 0.0      # P[sat is slow], per round
    straggler_extra_s: float = 30.0  # wall-clock penalty of a straggler
    corrupt_rate: float = 0.0        # P[payload tampered in flight], per edge
    fault_seed: int = 0              # fault-site mixer seed (≠ model seed)
    on_fault: str = "drop"           # drop | raise — degrade per mode or
    #   surface the first fault of a round as a FaultError subclass
    max_retries: int = 0             # async: retransmissions per update
    retry_backoff_steps: int = 1     # async: base backoff (trace steps),
    #   doubling per failed attempt (bounded exponential backoff)

    seed: int = 0
    eval_every: int = 1

    def __post_init__(self):
        # a config typo must fail loudly at construction, never deep
        # inside a jitted stage or by silently picking weaker behavior
        if self.mode not in ("qfl", "sim", "seq", "async"):
            raise ValueError(
                f"mode must be one of 'qfl'/'sim'/'seq'/'async', "
                f"got {self.mode!r}")
        if self.security not in ("none", "qkd", "qkd_fernet", "teleport"):
            raise ValueError(
                f"security must be one of 'none'/'qkd'/'qkd_fernet'/"
                f"'teleport', got {self.security!r}")
        if self.on_qber_abort not in ("raise", "drop"):
            raise ValueError(
                f"on_qber_abort must be 'raise' or 'drop', "
                f"got {self.on_qber_abort!r}")
        if self.agg_security not in ("none", "secagg"):
            raise ValueError(
                f"agg_security must be 'none' or 'secagg', "
                f"got {self.agg_security!r}")
        if self.agg_security == "secagg" and self.mode != "async":
            raise ValueError(
                "agg_security='secagg' is the async staleness-buffer "
                "dropout scenario; set mode='async'")
        if self.max_staleness < 0:
            raise ValueError(
                f"max_staleness is a round count (Δ_max ≥ 0), "
                f"got {self.max_staleness}")
        for name in ("n_rounds", "local_steps", "batch_size"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be ≥ 1, "
                                 f"got {getattr(self, name)}")
        # --- fault plane ---------------------------------------------------
        for name in ("link_flap_rate", "crash_rate", "straggler_rate",
                     "corrupt_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} is a probability, got {v}")
        if self.straggler_extra_s < 0:
            raise ValueError(
                f"straggler_extra_s must be ≥ 0, "
                f"got {self.straggler_extra_s}")
        if self.on_fault not in ("raise", "drop"):
            raise ValueError(
                f"on_fault must be 'raise' or 'drop', got {self.on_fault!r}")
        if self.max_retries < 0:
            raise ValueError(
                f"max_retries must be ≥ 0, got {self.max_retries}")
        if self.retry_backoff_steps < 1:
            raise ValueError(
                f"retry_backoff_steps must be ≥ 1, "
                f"got {self.retry_backoff_steps}")
        if self.max_retries > 0 and self.mode != "async":
            raise ValueError(
                "max_retries models the async retransmit path; "
                "set mode='async' (other modes drop faulted rows)")
        if self.corrupt_rate > 0 and not (
                self.verify_mac and self.security in ("qkd", "qkd_fernet")):
            raise ValueError(
                "corrupt_rate > 0 needs a receiver that can DETECT "
                "corruption: security in ('qkd', 'qkd_fernet') with "
                "verify_mac=True")

    def replace(self, **kw) -> "SatQFLConfig":
        return dataclasses.replace(self, **kw)
