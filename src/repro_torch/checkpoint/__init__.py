"""Checkpoints and reshard plans (counterpart of ``repro.checkpoint``)."""
from .checkpoint import latest_step, prune, restore, save
from .reshard import cross_stack_reshard_plan, reshard_plan, shard_owners

__all__ = ["latest_step", "prune", "restore", "save", "reshard_plan",
           "cross_stack_reshard_plan", "shard_owners"]
