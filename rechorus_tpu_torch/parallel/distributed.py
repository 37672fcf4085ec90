"""Multi-process start (port of rechorus_tpu/parallel/distributed.py).

One process per mesh position, each holding one device (a CUDA card, or
the CPU with `--gpu ''`), joined by `torch.distributed`: NCCL when the
ranks hold CUDA devices, gloo when they hold CPUs. A run becomes
multi-host by launching the SAME CLI once per host with
`--dist_coordinator host:port --dist_num_processes P --dist_process_id i`
(or the RECHORUS_COORDINATOR / RECHORUS_NUM_PROCESSES /
RECHORUS_PROCESS_ID environment variables). A host runs
`world / P` local ranks, numbered as `torchrun --nnodes P
--nproc_per_node L` numbers them: global rank = process_id * L +
local_rank; world = data_parallel * model_parallel (at least P). With a
mesh and no coordinator, `main` starts the dp * mp local ranks itself on
127.0.0.1 (torch.multiprocessing.spawn).

Every rank loads the same corpus and draws the same random streams, so
each builds the same global batch and keeps its own rows of it
(runners/base.py); the collectives are explicit (parallel/mesh.py).
"""
from __future__ import annotations

import dataclasses
import logging
import os
import socket
from datetime import timedelta

import torch
import torch.distributed as dist


def parse_dist_args(parser):
    parser.add_argument("--dist_coordinator", type=str, default="",
                        help="host:port of process 0 (its TCP store). Empty = one "
                             "process, which starts the mesh's local ranks itself.")
    parser.add_argument("--dist_num_processes", type=int, default=0,
                        help="Total processes (hosts) in the job (with --dist_coordinator).")
    parser.add_argument("--dist_process_id", type=int, default=-1,
                        help="This process's id (with --dist_coordinator).")
    return parser


@dataclasses.dataclass(frozen=True)
class DistPlan:
    """Where the ranks of a run live: `coordinator` host:port, `world`
    ranks over `num_processes` processes of `local` ranks each, this
    process's id."""
    coordinator: str
    world: int
    num_processes: int
    process_id: int
    local: int

    def global_rank(self, local_rank: int) -> int:
        return self.process_id * self.local + local_rank


def mesh_size(args) -> tuple:
    return max(1, int(getattr(args, "data_parallel", 1))), max(1, int(getattr(args, "model_parallel", 1)))


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def plan(args):
    """The DistPlan of a command line, or None for a plain one-process run:
    the flags (else the RECHORUS_* environment variables) name the
    coordinator; a mesh (dp * mp > 1) without one runs all its ranks on
    this host behind a coordinator at a free port of 127.0.0.1."""
    coord = getattr(args, "dist_coordinator", "") or os.environ.get("RECHORUS_COORDINATOR", "")
    dp, mp = mesh_size(args)
    if not coord:
        if dp * mp == 1:
            return None
        return DistPlan(f"127.0.0.1:{free_port()}", dp * mp, 1, 0, dp * mp)
    n = int(getattr(args, "dist_num_processes", 0) or os.environ.get("RECHORUS_NUM_PROCESSES", 0) or 1)
    pid = int(getattr(args, "dist_process_id", -1))
    if pid < 0:
        pid = int(os.environ.get("RECHORUS_PROCESS_ID", 0))
    world = max(dp * mp, n)
    if world % n:
        raise ValueError(f"mesh {dp}x{mp}: {world} ranks do not divide over {n} processes")
    if not 0 <= pid < n:
        raise ValueError(f"--dist_process_id {pid} outside [0, {n})")
    return DistPlan(coord, world, n, pid, world // n)


def start_plan(args):
    """`plan(args)` after the one refusal of a mesh the devices cannot
    hold (`check_devices`), before anything is built; `main` and `exp`
    start their runs from it. A host of several local ranks puts rank i
    on cuda:i, so there `--gpu` must be left at 0."""
    p = plan(args)
    check_devices(args, p.num_processes if p is not None else 1)
    gpu = str(getattr(args, "gpu", "0")).strip()
    if p is not None and p.local > 1 and gpu != "" and int(gpu.split(",")[0]) != 0:
        raise ValueError(f"--gpu {gpu}: the {p.local} ranks of a host run on cuda:0 .. "
                         f"cuda:{p.local - 1}; leave --gpu at 0")
    return p


def check_devices(args, n_processes: int = 1) -> None:
    """The JAX package's refusal of a mesh larger than the devices at hand,
    before anything is built: CUDA ranks need one card each on their host
    (no rank falls back to the CPU, no mesh shrinks to fit)."""
    dp, mp = mesh_size(args)
    if dp * mp == 1 or str(getattr(args, "gpu", "0")).strip() == "":
        return
    have = torch.cuda.device_count() * max(1, n_processes)
    if dp * mp > have:
        raise ValueError(f"mesh {dp}x{mp} needs {dp * mp} devices, have {have}")


# this process's rank on its host, its card (a CUDA rank's), the number of
# processes (hosts) of the run and this one's id
_LOCAL_RANK = 0
_CARD = 0
_NUM_PROCESSES = 1
_PROCESS_ID = 0


def local_rank() -> int:
    return _LOCAL_RANK


def card() -> int:
    """The CUDA card of this rank (`initialize`)."""
    return _CARD


def num_processes() -> int:
    return _NUM_PROCESSES


def process_id() -> int:
    return _PROCESS_ID


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def backend_initialized(name: str) -> bool:
    return is_distributed() and dist.get_backend() == name


def barrier() -> None:
    if is_distributed():
        dist.barrier()


def backend_for(gpu: str) -> str:
    """NCCL when the ranks hold CUDA devices, gloo when they hold CPUs:
    the backend follows from the device."""
    return "gloo" if str(gpu).strip() == "" else "nccl"


def initialize(p: DistPlan, local_rank_: int, gpu: str) -> None:
    """init_process_group for this rank; it must run before the corpus and
    the model are built. A CUDA rank first makes its card its current
    device: cuda:<local rank> on a host of several ranks, the `--gpu` id
    on a host of one."""
    global _LOCAL_RANK, _CARD, _NUM_PROCESSES, _PROCESS_ID
    _LOCAL_RANK, _NUM_PROCESSES, _PROCESS_ID = local_rank_, p.num_processes, p.process_id
    backend = backend_for(gpu)
    if backend == "nccl":
        _CARD = local_rank_ if p.local > 1 else int(str(gpu).split(",")[0])
        torch.cuda.set_device(_CARD)
    rank = p.global_rank(local_rank_)
    dist.init_process_group(backend=backend, init_method=f"tcp://{p.coordinator}",
                            world_size=p.world, rank=rank, timeout=timedelta(minutes=30))
    logging.info("torch.distributed: backend %s, rank %d/%d (process %d/%d, local rank %d)",
                 dist.get_backend(), rank, p.world, p.process_id, p.num_processes, local_rank_)


def maybe_initialize(args) -> bool:
    """Initialize this process as the ONE rank of its host when the flags
    or the environment name a coordinator and the host runs one rank (a
    plan with more local ranks is started by spawning them). Returns True
    if it initialized."""
    p = plan(args)
    if p is None or p.local != 1:
        return False
    initialize(p, 0, getattr(args, "gpu", "0"))
    return True


def shutdown() -> None:
    """destroy_process_group (and forget the meshes built on it)."""
    global _LOCAL_RANK, _CARD, _NUM_PROCESSES, _PROCESS_ID
    from rechorus_tpu_torch.parallel.mesh import reset_meshes, set_table_row_pad

    if is_distributed():
        dist.destroy_process_group()
    reset_meshes()
    set_table_row_pad(1)
    _LOCAL_RANK, _CARD, _NUM_PROCESSES, _PROCESS_ID = 0, 0, 1, 0


def is_rank0() -> bool:
    return not is_distributed() or dist.get_rank() == 0

