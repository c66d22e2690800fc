from .train import make_train_step, softmax_xent

__all__ = ["make_train_step", "softmax_xent"]
