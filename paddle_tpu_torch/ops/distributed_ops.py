"""Collective bootstrap, after paddle_tpu/ops/distributed_ops.py: only
`gen_collective_id`, the counterpart of the reference's gen_nccl_id
(gen_nccl_id_op.cc:31), which the collective-mode DistributeTranspiler
prepends to the startup program.

With `PADDLE_COORDINATOR` ("host:port" of rank 0) set it joins the
process to the torch.distributed world of num_trainers ranks
(parallel/mesh.py init_collective: NCCL when the startup program runs on
a card, gloo on the CPU, with an explicit timeout), where the JAX op
calls jax.distributed.initialize.  A launcher's world of one is a world
too (its collectives still run through NCCL), where the JAX op joins
only for num_trainers > 1.  It returns [trainer_id], as the JAX op.  The
pserver ops (send, recv, listen_and_serv, ...) are not ported
(ROADMAP.md, queue 1 item 12).
"""

import os

import torch

from ..parallel.mesh import init_collective
from .registry import register_op

__all__ = []


@register_op("gen_collective_id")
def _gen_collective_id(ctx):
    num = int(ctx.attr("num_trainers", 1) or 1)
    tid = int(ctx.attr("trainer_id", 0) or 0)
    coordinator = os.environ.get("PADDLE_COORDINATOR")
    if coordinator and ctx.device.type != "meta":
        init_collective(coordinator, num, tid, device_type=ctx.device.type)
    return {"Out": torch.tensor([tid], dtype=torch.int64, device=ctx.device)}
