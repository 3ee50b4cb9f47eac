from .base import LossModel, as_loss_model
from .mnist_cnn import CNN, MnistLossModel
from .nanogpt import GPT, GPTConfig, estimate_mfu, num_params

__all__ = ["LossModel", "as_loss_model", "CNN", "MnistLossModel", "GPT",
           "GPTConfig", "estimate_mfu", "num_params"]
