"""Plain float32 PyTorch references of the benchmark's models.

Each module here is written from the published definitions alone: it
imports neither JAX nor any module of the program under test, and takes
nothing the program made. `dau` holds the DAU convolution; one module per
architecture (`alexnet_dau`, `dau_resnet`) holds its parameter list, its
forward pass and, in training mode, its batch statistics; `train` runs the
loss, the gradients and the SGD update.
"""
