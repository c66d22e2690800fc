from .mesh import (P, NamedSharding, batch_sharding, dau_param_spec, make_mesh,
                   param_shardings, spatial_dau_conv2d, spatial_sharding)
from .train import (StateShardings, TrainState, gather_state, init_sharded, make_train_step,
                    softmax_xent)

__all__ = [
    "P",
    "NamedSharding",
    "batch_sharding",
    "dau_param_spec",
    "make_mesh",
    "param_shardings",
    "spatial_sharding",
    "spatial_dau_conv2d",
    "TrainState",
    "StateShardings",
    "init_sharded",
    "gather_state",
    "make_train_step",
    "softmax_xent",
]
