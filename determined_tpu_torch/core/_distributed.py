"""DistributedContext — process topology + host-level control-plane collectives.

Counterpart of determined_tpu/core/_distributed.py. The control plane
moves arbitrary pickled python objects between the processes of a run
(sharded-checkpoint metadata, the searcher's op lengths, the preemption
decision): `gather`, `allgather` and `broadcast` pickle them over three
byte collectives, `allgather_bytes`, `broadcast_bytes` and `barrier`, with
the JAX package's protocol: every rank sends its length first, then a
uint8 buffer padded to the longest, so all ranks contribute one shape.

Transports:
  - `_GlooTransport`  — the production path: a gloo process group over
    every rank. The control plane stays on gloo (host memory) even when
    the data plane is NCCL, as the JAX package keeps it off the gradient
    path.
  - `_ThreadTransport`— threads-as-hosts, for tests and local simulation
    (copied from the JAX package).

Topology: PyTorch on GPUs runs one process per device (JAX one per host,
owning every local chip), so `rank` and `size` count devices here:
  rank        — this process's index in the run (torch.distributed rank)
  size        — number of processes that train: the world size, or the
                prefix of it an elastic run trains over (`resize`)
  local_rank  — this process's index on its host (selects its device)

`resize(n)` narrows or widens the context in place to the ranks 0..n-1:
every holder (the checkpoint, preemption, searcher and train contexts,
`TrialContext.distributed`) sees the new `size`, and the control plane
moves to a gloo group over those ranks. A rank at or past `size` stands
by (`active` False) and takes part in no collective of the context.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import threading
from datetime import timedelta
from typing import Any, List, Optional

TORCH_BACKENDS = ("nccl", "gloo")


class _GlooTransport:
    """Byte collectives over a gloo process group (`group` None: the
    default group, itself gloo)."""

    def __init__(self, group=None):
        self._group = group

    def allgather_bytes(self, payload: bytes) -> List[bytes]:
        import torch
        import torch.distributed as dist

        n = torch.tensor([len(payload)], dtype=torch.int64)
        size = dist.get_world_size(self._group)
        lengths = [torch.zeros(1, dtype=torch.int64) for _ in range(size)]
        dist.all_gather(lengths, n, group=self._group)
        lengths = [int(t.item()) for t in lengths]
        maxlen = max(1, max(lengths))
        buf = torch.zeros(maxlen, dtype=torch.uint8)
        if payload:
            buf[: len(payload)] = torch.frombuffer(bytearray(payload),
                                                   dtype=torch.uint8)
        out = [torch.zeros(maxlen, dtype=torch.uint8) for _ in range(size)]
        dist.all_gather(out, buf, group=self._group)
        return [bytes(o[:k].numpy()) for o, k in zip(out, lengths)]

    def broadcast_bytes(self, payload: bytes, is_source: bool) -> bytes:
        import torch
        import torch.distributed as dist

        src = dist.get_global_rank(self._group, 0) if self._group is not None \
            else 0
        n = torch.tensor([len(payload) if is_source else 0], dtype=torch.int64)
        dist.broadcast(n, src=src, group=self._group)
        n = int(n.item())
        buf = torch.zeros(max(1, n), dtype=torch.uint8)
        if is_source and n:
            buf[:n] = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
        dist.broadcast(buf, src=src, group=self._group)
        return bytes(buf[:n].numpy())

    def barrier(self, name: str) -> None:
        import torch.distributed as dist

        dist.barrier(group=self._group)


class _ThreadSharedState:
    def __init__(self, size: int):
        self.size = size
        self.barrier = threading.Barrier(size)
        self.slots: List[Optional[bytes]] = [None] * size
        self.bcast: Optional[bytes] = None


class _ThreadTransport:
    """Threads-as-hosts transport: N threads share one state object.

    Build one per rank via `make_thread_transports(n)`. Double barrier =
    publish / read-before-reuse."""

    def __init__(self, shared: _ThreadSharedState, rank: int):
        self._shared = shared
        self._rank = rank

    def allgather_bytes(self, payload: bytes) -> List[bytes]:
        s = self._shared
        s.slots[self._rank] = payload
        s.barrier.wait()
        out = list(s.slots)  # type: ignore[arg-type]
        s.barrier.wait()
        return out  # type: ignore[return-value]

    def broadcast_bytes(self, payload: bytes, is_source: bool) -> bytes:
        s = self._shared
        if is_source:
            s.bcast = payload
        s.barrier.wait()
        out = s.bcast
        s.barrier.wait()
        assert out is not None
        return out

    def barrier(self, name: str) -> None:
        self._shared.barrier.wait()


def make_thread_transports(size: int) -> List[_ThreadTransport]:
    shared = _ThreadSharedState(size)
    return [_ThreadTransport(shared, r) for r in range(size)]


def _init_method(coordinator_addr: str) -> str:
    """"host:port" -> tcp://host:port; a URL (tcp://, file://, env://) as
    it is."""
    return coordinator_addr if "://" in coordinator_addr \
        else f"tcp://{coordinator_addr}"


@dataclasses.dataclass
class DistributedContext:
    rank: int = 0
    size: int = 1
    local_rank: int = 0
    backend: Optional[str] = None  # the data plane's: nccl | gloo
    initialized_process_group: bool = False
    transport: Optional[Any] = None  # byte-level collectives (size>1 only)
    # The world's control plane, kept while `resize` narrows the context.
    _world_transport: Optional[Any] = dataclasses.field(default=None,
                                                        repr=False)

    @property
    def is_chief(self) -> bool:
        return self.rank == 0

    @property
    def active(self) -> bool:
        """False on a rank an elastic run keeps standing by (`resize`)."""
        return self.rank < self.size

    def resize(self, size: int) -> None:
        """Narrow or widen this context, in place, to the ranks 0..size-1
        of the process group's world: `size` becomes `size`, and the
        control plane a gloo group over those ranks (the world's own,
        kept from bring-up, when `size` is the whole world). The group is
        made with `new_group`, collective over the whole world: every
        rank, standing by or not, calls this with the same `size` in the
        same order. The narrowed group it leaves is destroyed."""
        import torch.distributed as dist

        if not self.initialized_process_group:
            raise RuntimeError("resize needs the process group this context "
                               "formed (from_allocation / from_env)")
        world = dist.get_world_size()
        if not 1 <= size <= world:
            raise ValueError(f"resize to {size} ranks in a world of {world}")
        if size == self.size:
            return
        if self._world_transport is None:
            self._world_transport = self.transport
        old = self.transport
        if size == world:
            self.transport = self._world_transport
        else:
            group = dist.new_group(ranks=list(range(size)), backend="gloo")
            self.transport = _GlooTransport(group) if self.rank < size \
                else None
        if old is not None and old is not self._world_transport:
            dist.destroy_process_group(old._group)
        self.size = size

    # -- constructors -------------------------------------------------

    @classmethod
    def local(cls) -> "DistributedContext":
        return cls(rank=0, size=1)

    @classmethod
    def from_allocation(
        cls,
        coordinator_addr: str,
        num_processes: int,
        process_id: int,
        backend: str = "nccl",
        local_rank: int = 0,
        timeout_s: float = 1800.0,
    ) -> "DistributedContext":
        """Multi-process bring-up: the chief's address (a rendezvous's
        coordinator, or the launcher's MASTER_ADDR:MASTER_PORT; a
        `file://` or `tcp://` URL is taken as it is), the world size and
        this process's rank go to `torch.distributed.init_process_group`.
        `backend` is the data plane's: "nccl" (the default: one CUDA
        device per process, selected by `local_rank` before the group
        forms) or "gloo", which runs on the CPU and is taken only when
        named. The control plane is a gloo group in either case.

        A world of one process makes a process group too when `backend`
        is named, so a launched single-slot trial builds its DeviceMesh
        the same way as a wider one."""
        if backend not in TORCH_BACKENDS:
            raise ValueError(f"backend {backend!r} not in {TORCH_BACKENDS}")
        import torch
        import torch.distributed as dist

        if backend == "nccl":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "the nccl backend needs a CUDA device; set "
                    "DET_TORCH_BACKEND=gloo to run the process group on the "
                    "CPU explicitly")
            torch.cuda.set_device(local_rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=_init_method(coordinator_addr),
            rank=process_id, world_size=num_processes,
            timeout=timedelta(seconds=timeout_s))
        group = dist.new_group(backend="gloo") if backend == "nccl" else None
        return cls(rank=process_id, size=num_processes,
                   local_rank=local_rank, backend=backend,
                   initialized_process_group=True,
                   transport=_GlooTransport(group))

    @classmethod
    def from_env(cls, env=None) -> Optional["DistributedContext"]:
        """The launcher's contract (`launch/torch_distributed.py`): RANK,
        WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT and
        DET_TORCH_BACKEND. None when WORLD_SIZE is not set."""
        env = os.environ if env is None else env
        if "WORLD_SIZE" not in env:
            return None
        addr = f"{env.get('MASTER_ADDR', '127.0.0.1')}:" \
               f"{env.get('MASTER_PORT', '29400')}"
        return cls.from_allocation(
            addr, int(env["WORLD_SIZE"]), int(env.get("RANK", "0")),
            backend=env.get("DET_TORCH_BACKEND", "nccl"),
            local_rank=int(env.get("LOCAL_RANK", "0")))

    @classmethod
    def for_test(cls, rank: int, size: int, transport: Any) -> "DistributedContext":
        """Threads-as-hosts context (pair with make_thread_transports)."""
        return cls(rank=rank, size=size, transport=transport)

    # -- control-plane collectives ------------------------------------
    # Arbitrary pickleable objects, like the reference's ZMQ plane:
    # dicts, strings, numpy arrays, ...

    def gather(self, obj: Any) -> Optional[List[Any]]:
        """Gather python objects to the chief (None on non-chief ranks)."""
        if self.size == 1:
            return [obj]
        vals = self.allgather(obj)
        return vals if self.is_chief else None

    def allgather(self, obj: Any) -> List[Any]:
        if self.size == 1:
            return [obj]
        payloads = self._t().allgather_bytes(pickle.dumps(obj))
        return [pickle.loads(p) for p in payloads]

    def broadcast(self, obj: Any) -> Any:
        if self.size == 1:
            return obj
        payload = pickle.dumps(obj) if self.is_chief else b""
        return pickle.loads(self._t().broadcast_bytes(payload, self.is_chief))

    def barrier(self, name: str = "barrier") -> None:
        if self.size == 1:
            return
        self._t().barrier(name)

    def _t(self) -> Any:
        if self.transport is None:
            raise RuntimeError(
                "DistributedContext of size > 1 without a transport: build "
                "it with from_allocation/from_env or for_test")
        return self.transport

    def shutdown(self) -> None:
        if self.initialized_process_group:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()
            self.initialized_process_group = False
