"""Parallelism: process groups, device meshes and data-parallel optimizer
steps over ``torch.distributed`` (port of
:mod:`pytorchhessianfree_tpu.parallel`)."""
