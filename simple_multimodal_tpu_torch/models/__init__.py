"""The port's models. Import the modules directly, e.g.
``simple_multimodal_tpu_torch.models.multimodal_model``."""
