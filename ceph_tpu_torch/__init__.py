"""PyTorch/CUDA port of ceph_tpu.

The erasure-code data path (the `tpu` plugin, its GF(2^8) kernels and the
batched ECUtil encode/decode) on an NVIDIA Hopper card, with hand-written
CUDA kernels.  Everything runs on `cuda` unless the caller passes
`device="cpu"`, where the kernels' plain PyTorch versions run instead.
The package imports neither JAX nor anything of `ceph_tpu`.
"""
