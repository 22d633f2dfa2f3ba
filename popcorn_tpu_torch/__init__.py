"""popcorn_tpu_torch: the PyTorch/CUDA port of popcorn_tpu for NVIDIA Hopper.

The JAX package ``popcorn_tpu`` stays the reference; this package imports
nothing from it. Its hot kernels are hand-written CUDA C++ in ``csrc/``,
built with nvcc at first use. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.

    from popcorn_tpu_torch import DataPaths, ModelConfig, TrainConfig, EvalConfig
    from popcorn_tpu_torch.infer.evaluator import Evaluator
"""

from .config import DataPaths, EvalConfig, ModelConfig, TrainConfig

__version__ = "0.1.0"

__all__ = ["DataPaths", "EvalConfig", "ModelConfig", "TrainConfig", "__version__"]
