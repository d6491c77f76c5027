"""PyTorch/CUDA port of behavior_driven_video_synthesis_tpu for one NVIDIA
H100.

The JAX package beside this one is the reference: every module here mirrors
its counterpart's path (``ops/nn.py`` <-> ``ops/nn.py``, ...), keeps its
public layouts (NHWC images, (B, T, K) sequences, (B, H) latents) and loads
its parameter trees through ``models/convert.py``.  This package imports
``torch`` and never ``jax``.

Slice 1 ports the behavior-transfer serving path: flow inverse -> residual
LSTM rollout (a hand-written CUDA kernel, ``csrc/rollout.cu``) -> camera
projection -> stickman raster -> VUNet-alter synthesis, driven by
``generate.py`` (``bdvs-generate-torch``).
"""
