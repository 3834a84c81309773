from .checkpoint import Checkpointer, TrainState
from .progress import StepTimer
from .rng import CRandom

__all__ = ["Checkpointer", "TrainState", "StepTimer", "CRandom"]
