"""DistributeTranspiler, collective mode, after
paddle_tpu/fluid/transpiler/distribute_transpiler.py (reference
distribute_transpiler.py `_transpile_nccl2` :212).

The only change to the programs is the bootstrap: `gen_collective_id` is
prepended to the startup program (it joins the torch.distributed world
before any initializer runs, ops/distributed_ops.py), and the main
program records `_num_trainers` and `_trainer_id` for the
ParallelExecutor.  The gradient all-reduce comes from running the main
program under the ParallelExecutor.  Transpiling changes nothing else: the
trainer's card is the launcher's FLAGS_selected_gpus (parallel/mesh.py
launch sets it, so an Executor on CUDAPlace(0) runs the startup program
on that card), or else the one gen_collective_id picks when it joins the
world (the ParallelExecutor then moves the state there).

Pserver mode (send/recv/listen_and_serv over the RPC layer) is not
ported: it raises.
"""

from ..framework import default_main_program

__all__ = ["DistributeTranspiler", "DistributeTranspilerConfig"]

RPC_OP_ROLE_ATTR = "op_role"
RPC_OP_ROLE_VALUE = "RPC"

_PSERVER_WAITS = ("pserver mode (the RPC layer and listen_and_serv) is not "
                  "ported to paddle_tpu_torch yet (ROADMAP.md, queue 1 item "
                  "12); set config.mode = 'collective'")


class DistributeTranspilerConfig:
    """reference distribute_transpiler.py:126; mode "collective" ("nccl2"
    is accepted as an alias) is the one ported.  The default is the JAX
    package's, "pserver", which raises."""

    mode = "pserver"


class DistributeTranspiler:
    """reference distribute_transpiler.py:239, collective mode."""

    def __init__(self, config=None):
        self.config = config if config is not None \
            else DistributeTranspilerConfig()

    def transpile(self, trainer_id, program=None, pservers="", trainers=1,
                  sync_mode=True, startup_program=None,
                  current_endpoint=""):
        if self.config.mode not in ("collective", "nccl2"):
            raise NotImplementedError("DistributeTranspiler: " +
                                      _PSERVER_WAITS)
        if program is None:
            program = default_main_program()
        self.origin_program = program
        self.trainer_id = int(trainer_id)
        self.trainer_num = int(trainers)
        if startup_program is not None:
            gb = startup_program.global_block()
            gb.create_var(name="CollectiveId", shape=(1,), dtype="int64",
                          persistable=True)
            # first: the world is joined before any initializer runs
            gb._prepend_op(
                type="gen_collective_id", inputs={},
                outputs={"Out": ["CollectiveId"]},
                attrs={"trainer_id": self.trainer_id,
                       "num_trainers": self.trainer_num,
                       RPC_OP_ROLE_ATTR: RPC_OP_ROLE_VALUE})
        program._num_trainers = self.trainer_num
        program._trainer_id = self.trainer_id
        self.trainer_program = program

    def get_trainer_program(self):
        return self.trainer_program

    def get_pserver_program(self, endpoint):
        raise NotImplementedError("get_pserver_program: " + _PSERVER_WAITS)
