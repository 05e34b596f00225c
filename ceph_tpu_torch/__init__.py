"""PyTorch/CUDA port of ceph_tpu.

The erasure-code data path (the plugin family, its GF(2^8) kernels, the
batched ECUtil encode/decode and compiled repair), CRUSH placement and
the placement tools, the multi-device EC mesh and its OSD-side fabric,
the benchmark CLI and the sanitizers, on an NVIDIA Hopper card with
hand-written CUDA kernels.  Everything runs on `cuda` unless the caller
passes `device="cpu"`, where the kernels' plain PyTorch versions run
instead.  The package imports neither JAX nor anything of `ceph_tpu`.
"""
