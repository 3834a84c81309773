from .checkpoint import Checkpointer, TrainState
from .progress import Mprint, StepTimer
from .rng import CRandom

__all__ = ["Checkpointer", "TrainState", "Mprint", "StepTimer", "CRandom"]
