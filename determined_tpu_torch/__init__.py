"""determined_tpu_torch: the platform's compute package on PyTorch and CUDA.

A port of `determined_tpu` (JAX on a TPU) to PyTorch on an NVIDIA H100,
one slice at a time. It keeps `determined_tpu`'s module layout and names so
each module's counterpart is easy to find, imports `torch`, numpy and the
standard library only, and never imports `jax` or `determined_tpu`.

Slices ported so far:
  serve/   GPT-2 serving with a paged (or dense) KV pool through CUDA
           graphs: the hand-written CUDA paged decode-attention kernel
           (ops/csrc/paged_attention.cu), the continuous batcher, adapters,
           request tracing, the HTTP front-end and the replica entry point
           (`python -m determined_tpu_torch.serve cfg.json`).
  train/   GPT-2 training through `Trainer(trial).fit()` with the
           hand-written flash-attention kernels
           (ops/csrc/flash_attention.cu), the device prefetcher (data/)
           and background checkpoint writes.
  core/    the Core API in local and managed mode (`_info.py`: the
           `DET_*` environment; `common/api.py`: the master session;
           `experimental/core_v2`: unmanaged runs; `tensorboard/`), in
           one process or many (`core/_distributed.py`: the process group
           and the control-plane collectives).
  parallel/ the DeviceMesh over the run's processes and the logical
           sharding rules: training over the `data` and `fsdp` axes.
  launch/, exec/  one worker process per GPU slot (`DET_SLOT_IDS`), and
           the task entry point that prepares and launches them.
  storage/ the checkpoint storage backends (shared_fs, directory, gcs,
           s3, azure) under the Core API's checkpoints.
  pytorch/ the class-based trial APIs: PyTorchTrial, DeepSpeedTrial and
           the ZeRO-1 engine.
  analysis/ the preflight: config rules, a lint of step functions and a
           per-device memory estimate on the meta device
           (`python -m determined_tpu_torch.analysis`).

Entry points run on CUDA unless the caller passes `device="cpu"`
(`_device.resolve_device`).
"""

from determined_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
