"""Measurement tools of the port, run as modules on the GPU
(``python -m ecg_representation_learning_tpu_torch.tools.<name>``)."""
