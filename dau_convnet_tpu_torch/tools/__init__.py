"""Measurement tools of the port that run on the card (`python -m
dau_convnet_tpu_torch.tools.<name>`); nothing here runs at import."""
