"""The benchmark of the PyTorch/CUDA port (`dau_convnet_tpu_torch`): run one
cell with `python3 -m portbench.run`; see README.md."""
