"""Parallelism: process groups, device meshes, data-parallel and
solver-state-sharded optimizer steps over ``torch.distributed``, and the
differentiable collectives the models' forwards call (port of
:mod:`pytorchhessianfree_tpu.parallel`)."""
