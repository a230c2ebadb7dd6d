"""Small module helpers shared by the port's models."""
import torch.nn as nn


class Group(nn.Module):
    """A named container: registers keyword submodules and parameters, so
    nested state-dict names follow the HF/reference layout
    (``attention.attention.query.weight``, ...). It has no forward."""

    def __init__(this, /, **members):  # `this`: a member may be called "self"
        super().__init__()
        for name, member in members.items():
            setattr(this, name, member)
