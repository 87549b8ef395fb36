"""Rank bodies for ``tests/test_torch_distributed.py``'s spawned gloo ranks.

A spawned rank imports the module that holds its function; this one needs
only torch and the port, so a rank starts without loading JAX.
"""
import time

import torch
import torch.distributed as dist

from repro_torch.core import distributed as D


def sharded_attention(rank, n, q, state, retro, plan, q2, state2, plan2):
    """One rank: its block of both states, the sharded attention of each."""
    torch.set_num_threads(1)
    out = [D.distributed_wave_attention(qq, D.shard_state(st, rank, n),
                                        retro, pl)
           for qq, st, pl in ((q, state, plan), (q2, state2, plan2))]
    return [o.numpy() for o in out]


def stalling(rank, n):
    """The last rank never reaches the collective."""
    if rank == n - 1:
        time.sleep(300)
    t = torch.ones(3)
    dist.all_reduce(t)
    return t.numpy()
