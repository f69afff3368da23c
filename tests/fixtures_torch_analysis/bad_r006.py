"""R006 fixture: blocking collective inside an async service function."""
import torch.distributed as dist

from repro_torch.core import api


def async_plan_loop(stack, group):       # R006: all_reduce waits on all
    dist.all_reduce(stack, group=group)
    return api._all_gather(stack, group, 2)   # R006: the port's gather


def sync_step_is_fine(stack):
    dist.all_reduce(stack)
    return stack
