"""Preference mapping for pairwise training.

Port of ``vtamiq_tpu/models/preference.py``. A pairwise step scores
(ref, distA) and (ref, distB) and maps the two scores to the probability
that image A is preferred. The two maps have opposite signs, as in the
reference: the learned module reads ``sigmoid(p * (q2 - q1))`` (lower q =
better quality), the parameter-free default ``sigmoid(q1 - q2)``.
"""

from __future__ import annotations

import torch
from torch import nn


class PreferenceModule(nn.Module):
    """One learnable scalar ``p`` scaling the quality difference; init 6.0
    maps sigmoid outputs onto JOD-unit preferences. Attached to a VTAMIQ
    model as ``pref_module``, so the optimizer and the freeze mask see it
    as ``pref_module.p``."""

    def __init__(self, weight: float = 6.0):
        super().__init__()
        self.p = nn.Parameter(torch.tensor(float(weight), dtype=torch.float32))


def preference_forward(module: PreferenceModule, q1: torch.Tensor,
                       q2: torch.Tensor) -> torch.Tensor:
    """P(prefer image 1) = sigmoid(p * (q2 - q1)), flattened."""
    return torch.sigmoid(module.p * (q2 - q1)).reshape(-1)


def preference_sigmoid(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """The parameter-free default: sigmoid(q1 - q2), flattened."""
    return torch.sigmoid(q1 - q2).reshape(-1)


def attach_preference_module(model: nn.Module, weight: float = 6.0) -> PreferenceModule:
    """Give ``model`` a ``pref_module`` (on the model's device) and return
    it."""
    device = next(model.parameters()).device
    model.pref_module = PreferenceModule(weight).to(device)
    return model.pref_module
