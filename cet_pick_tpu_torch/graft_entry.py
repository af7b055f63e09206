"""Entry point of the port for a quick forward check: the counterpart of
``entry()`` in the JAX package's ``__graft_entry__.py`` (:24-43), a forward
of the flagship model.

``entry(device)`` returns ``(fn, (model, x))``: the ``unet_4`` ``semi``
``TomoPickNet`` with flax's initializers on ``device``, ``x`` zeros of
shape (2, 6, 64, 64), and ``fn(model, volume) -> {'hm', 'proj'}``, an eval
forward on the model's device (on the card its feature head launches the
z-tap kernel twice). The JAX ``dryrun_multichip`` has no counterpart yet.
"""

from __future__ import annotations

import numpy as np
import torch

from cet_pick_tpu_torch.config import Config
from cet_pick_tpu_torch.infer.detector import resolve_device
from cet_pick_tpu_torch.models.detector import create_detector

ENTRY_SHAPE = (2, 6, 64, 64)


def entry(device="cuda"):
    """(fn, (model, x)) of the flagship forward; the model's weights are
    drawn under ``torch.manual_seed(0)`` from flax's initializers (JAX:
    ``PRNGKey(0)``)."""
    device = resolve_device(device)
    config = Config(task="semi", arch="unet_4").finalize()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = create_detector(config)
    model.to(device).eval()
    x = np.zeros(ENTRY_SHAPE, dtype=np.float32)

    def fn(model, volume):
        model.eval()
        dev = next(model.parameters()).device
        with torch.no_grad():
            return model(torch.as_tensor(volume, device=dev))

    return fn, (model, x)
