"""Multi-process start-up, as ``voicefixer_tpu/parallel/distributed.py``, on
``torch.distributed``.

The process model differs from the JAX package's on purpose. There, one
process runs per host and the mesh spans every chip of every host. Here one
process runs per card, PyTorch's own idiom: process K drives
``cuda:{K % torch.cuda.device_count()}``, and the process group is NCCL.
Only a caller that asks for the CPU (``device="cpu"``, the CLI's
``--disable-cuda``) gets gloo, as the CPU tests do; a failed NCCL start-up
raises and never falls back to gloo. Consecutive ranks share a host, so
``parallel.mesh.make_mesh`` puts them on the inner "model" axis and a model
group stays on one host's NVLink.

Entry points:
- CLI: ``python -m voicefixer_tpu_torch ... --coordinator host:port
  --num-processes N --process-id K``, one process per card.
- Environment: VF_COORDINATOR / VF_NUM_PROCESSES / VF_PROCESS_ID.
  VF_COORDINATOR=auto takes a launcher's RANK / WORLD_SIZE / MASTER_ADDR /
  MASTER_PORT (``env://``, as torchrun sets them).
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

_local_device: torch.device | None = None


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def _init_method(coordinator: str) -> str:
    if coordinator == "auto":
        return "env://"
    if "://" in coordinator:  # tcp://host:port or file:///path
        return coordinator
    return f"tcp://{coordinator}"


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device=None,
               timeout_s: float | None = None) -> bool:
    """Join the process group. Returns True once it is up (now or
    before), False when no coordinator is given anywhere: a single-process
    run, a no-op and not an error.

    The arguments default to VF_COORDINATOR, VF_NUM_PROCESSES and
    VF_PROCESS_ID. ``coordinator`` is ``host:port`` (TCP), a ``tcp://`` or
    ``file://`` URL, or ``auto`` (``env://``). With a coordinator and no
    process count, the run is a world of one. A process count or id without
    a coordinator, or an id outside [0, count), raises ValueError before
    anything starts.

    ``device``: None means the card, ``cuda:{process_id % device_count}``,
    on NCCL, and raises without one; "cpu" means gloo."""
    global _local_device
    if is_initialized():
        return True
    coordinator = coordinator or os.environ.get("VF_COORDINATOR") or None
    if num_processes is None and os.environ.get("VF_NUM_PROCESSES"):
        num_processes = int(os.environ["VF_NUM_PROCESSES"])
    if process_id is None and os.environ.get("VF_PROCESS_ID"):
        process_id = int(os.environ["VF_PROCESS_ID"])
    if coordinator is None:
        if num_processes is not None or process_id is not None:
            raise ValueError("a process count or id needs a coordinator "
                             "(--coordinator or VF_COORDINATOR)")
        return False
    if coordinator == "auto":
        num_processes = (int(os.environ["WORLD_SIZE"]) if num_processes
                         is None else num_processes)
        process_id = (int(os.environ["RANK"]) if process_id is None
                      else process_id)
    num_processes = 1 if num_processes is None else num_processes
    process_id = 0 if process_id is None else process_id
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is not in [0, "
                         f"{num_processes})")
    dev = torch.device("cuda" if device is None else device)
    kwargs = {}
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "(--disable-cuda) for a gloo group on the CPU")
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        # device_id starts NCCL's communicator now, so a failure raises here
        dist.init_process_group("nccl", init_method=_init_method(coordinator),
                                world_size=num_processes, rank=process_id,
                                device_id=dev, **kwargs)
    else:
        dist.init_process_group("gloo", init_method=_init_method(coordinator),
                                world_size=num_processes, rank=process_id,
                                **kwargs)
    _local_device = dev
    return True


def local_device() -> torch.device:
    """The device this process drives: its card, or the CPU in a gloo group
    that asked for it (``initialize(device="cpu")``). Without a process
    group, "cuda", and raises without a card: nothing carries on on the CPU
    unless asked to."""
    if _local_device is not None and is_initialized():
        return _local_device
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; initialize(device='cpu') "
                           "for a process group on the CPU")
    return torch.device("cuda")


def shutdown():
    """Leave the process group (after the last collective)."""
    global _local_device
    if is_initialized():
        dist.destroy_process_group()
    _local_device = None


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_primary() -> bool:
    """True on the process that writes shared outputs and prints logs."""
    return process_index() == 0


def barrier():
    """Wait for every process; a no-op without a process group."""
    if is_initialized():
        if _local_device is not None and _local_device.type == "cuda":
            dist.barrier(device_ids=[_local_device.index])
        else:
            dist.barrier()
