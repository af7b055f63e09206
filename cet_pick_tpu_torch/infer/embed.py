"""Embedding extraction for the exploration module — port of
``cet_pick_tpu/infer/embed.py:69-169``.

Rebuild of reference cet_pick/simsiam_test_hm_2d3d.py:151-245 (2d3d) and
simsiam_test_hm_3d.py (3d): re-mine the DoG candidates, normalize each patch
with the dataset statistics (test-time transforms are CenterCrop + Normalize
only, simsiam_test_hm_2d3d.py:47-53), run ``forward_test`` in batches of
256 (the last padded, so the forward sees one shape), and dump
``all_output_info.npz`` with the reference's keys, dtypes and order:

    proj, pred, name, coords, subvol               (2d and vol modes)
    proj, pred, name, coords, subvol, subvols_2d   (2d3d mode)

In vol mode each subvolume goes through the deterministic test view
(``ops/augment.vol_test_view``: centre crop, znorm / rescale / znorm), and
``subvol`` keeps the raw (N, *vol_size) crops.

Batch i+1's host -> device copy rides behind batch i's forward
(``data/prefetch.PrefetchIterator``), and batch i's outputs are fetched
after batch i+1 is enqueued.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from cet_pick_tpu_torch.data.prefetch import PrefetchIterator
from cet_pick_tpu_torch.ops.augment import vol_test_view


BATCH = 256


def extract_embeddings(model, dataset, device="cuda"):
    """``forward_test`` in eval mode over every candidate patch of a test
    ``ExploreDataset``, in batches of BATCH, on ``device`` (the card unless
    the caller passes ``device="cpu"``); returns the npz dict
    (embed.py:69-163)."""
    from cet_pick_tpu_torch.infer.detector import resolve_device

    device = resolve_device(device)
    two = model.mode == "2d3d"
    names, coords, p2s, p3s = [], [], [], []
    for name, coord, p2, p3 in dataset.test_items():
        names.append(name)
        coords.append(coord)
        p3s.append(p3)
        if two:
            p2s.append(p2)
    n = len(p3s)
    if n == 0:
        raise ValueError(
            "no candidate patches to embed — DoG mining found nothing in the "
            "test tomogram(s); lower --dog sigmas or check the input volume"
        )
    sub3 = np.stack(p3s).astype(np.float32)
    if model.mode == "vol":
        x3_all = vol_test_view(sub3)
    else:
        x3_all = (sub3 - dataset.mean_3d) / dataset.std_3d
    if two:
        sub2 = np.stack(p2s).astype(np.float32)
        x2_all = (sub2 - dataset.mean_2d) / dataset.std_2d

    def pad_batch(x):
        # the remainder batch repeats its last row up to BATCH; the extra
        # rows are sliced off the outputs
        if len(x) < BATCH:
            return np.concatenate([x, np.repeat(x[-1:], BATCH - len(x),
                                                axis=0)])
        return x

    def batches():
        for start in range(0, n, BATCH):
            end = min(start + BATCH, n)
            xs = (x2_all, x3_all) if two else (x3_all,)
            yield end - start, tuple(pad_batch(x[start:end])[:, None]
                                     for x in xs)

    projs, preds = [], []
    pending = None

    def drain(p):
        if p is not None:
            kept, out = p
            projs.append(out["proj"][:kept].cpu().numpy())
            preds.append(out["pred"][:kept].cpu().numpy())

    model.eval()
    with torch.no_grad(), PrefetchIterator(batches(), device=device) as it:
        for kept, xs in it:
            out = model.forward_test(*xs)
            drain(pending)
            pending = (kept, out)
    drain(pending)

    result = {
        "proj": np.concatenate(projs),
        "pred": np.concatenate(preds),
        "name": np.array(names),
        "coords": np.stack(coords),
        "subvol": sub3,
    }
    if two:
        result["subvols_2d"] = sub2
    return result


def save_embeddings(config, result):
    """Write ``save_dir/all_output_info.npz`` (simsiam_test_hm_2d3d.py:230-232)."""
    os.makedirs(config.save_dir, exist_ok=True)
    path = os.path.join(config.save_dir, "all_output_info.npz")
    np.savez(path, **result)
    return path
