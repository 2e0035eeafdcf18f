"""The benchmark's plain reference: a frozen copy of the port's plain code.

`core/`, `physics/`, `ops/` and `render/` are copies of the same files of
`garden_tpu_torch` as of the benchmark's first version (the physics step,
its math and configs, and the deferred renderer with every module it
imports), with three edits: the package name is `benchmark.reference`;
`render/raster._on_device` returns the plain version on every device, so
K1-K7 run as their plain PyTorch twins; and each loader of a hand-written
kernel raises where it would import `cuda_build`. Nothing here imports the
program, JAX or the JAX package, and nothing takes the program's weights,
tables or scene: `scenes.py` builds every world and frame from the
benchmark's generated inputs. A later change to the program does not
reach this copy.
"""
