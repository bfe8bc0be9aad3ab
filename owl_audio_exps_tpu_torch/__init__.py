"""owl_audio_exps_tpu_torch — PyTorch and CUDA port of owl_audio_exps_tpu for
NVIDIA Hopper. The JAX package beside it is the reference: module paths
mirror it, and every TPU kernel on a ported path is a hand-written CUDA
kernel under csrc/ with a plain PyTorch version beside its wrapper.
"""

__version__ = "0.1.0"

from .configs import Config, ConfigNode, transformer_config  # noqa: F401
