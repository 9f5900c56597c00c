"""Training: ``trainer`` (``make_train_step``, ``train_loop``) and ``metrics`` (step FLOPs, MFU)."""
