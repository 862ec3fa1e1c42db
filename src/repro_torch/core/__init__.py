"""sat-QFL core of the port: config, comm model, plan compiler, trainer."""
from repro_torch.core.comm import CommLog, CommModel
from repro_torch.core.flconfig import SatQFLConfig
from repro_torch.core.plan import RoundPlan, compile_round_plan
from repro_torch.core.round import RoundMetrics, SatQFLTrainer, evaluate

__all__ = ["CommLog", "CommModel", "SatQFLConfig", "RoundPlan",
           "compile_round_plan", "RoundMetrics", "SatQFLTrainer", "evaluate"]
