"""garden-tpu on PyTorch and CUDA: the port of `garden_tpu` to one NVIDIA
H100.

The package mirrors the JAX package's layout (core, physics, render,
systems, utils, net, the engine) and never imports JAX or `garden_tpu`. Plain tensor code is
PyTorch; each TPU Pallas kernel on the ported path becomes a hand-written
CUDA kernel under `csrc/`, with a plain PyTorch version beside it that CPU
tensors take. `entry.build` assembles the combined physics + frame step, and
`engine.Engine` the ECS runtime (`entry.build_engine_frame` draws one).
"""

__version__ = "0.1.0"
