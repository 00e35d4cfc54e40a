"""Step factories (counterpart of ``repro.train``): the inference steps
only; the training step waits for the training slice."""
from .state import make_prefill_step, make_serve_step

__all__ = ["make_prefill_step", "make_serve_step"]
