"""sat-QFL core of the port: config, comm model, plan compiler, and the
round at two scales — the host-orchestrated trainer (``round``) and the
in-graph stacked-satellite round (``dist``)."""
from repro_torch.core.comm import CommLog, CommModel
from repro_torch.core.dist import FLState, make_fl_round, make_secure_exchange
from repro_torch.core.flconfig import SatQFLConfig
from repro_torch.core.plan import (FaultSchedule, RoundPlan,
                                   compile_round_plan)
from repro_torch.core.round import (FaultReport, RoundMetrics, SatQFLTrainer,
                                    evaluate)

__all__ = ["CommLog", "CommModel", "SatQFLConfig", "RoundPlan",
           "compile_round_plan", "FaultSchedule", "FaultReport",
           "RoundMetrics", "SatQFLTrainer", "evaluate", "FLState",
           "make_fl_round", "make_secure_exchange"]
