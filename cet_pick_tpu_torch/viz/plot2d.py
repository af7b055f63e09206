"""Embedding clustering + 2D visualization — port of
``cet_pick_tpu/viz/plot2d.py`` (reference cet_pick/plot_2d.py:55-218), with
the same outputs:

* k-means to 256 centroids on the device (``ops/kmeans.py``, replacing
  FAISS, :70-72)
* sklearn SpectralClustering of the centroids to n_cluster labels (:74-77)
* per-point labels through the k-means assignment (:79-85)
* ``imgs/<i>.png`` patch thumbnails + ``interactive_info_parquet.gzip``
  with the columns name/coord/embeddings/label/image for the Phoenix
  session (:91-108)
* a UMAP 2D layout (t-SNE under ``--mode tsne``, and where umap-learn is
  not installed) scaled to the unit square (:112-120)
* ``all_colors.npy``, each point's 2D-colormap color for the 3D overlay
  (:138-139), and the two thumbnail scatter plots
  ``2d_visualization_out.webp`` / ``2d_visualization_labels.webp``
  (:121-218)

Only the k-means runs on the device; the rest is the JAX package's host
code, with its packages imported where they are used.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from cet_pick_tpu_torch.viz import require
from cet_pick_tpu_torch.viz.colormap2d import ColorMap2D

COMMAND = "plot2d"


def _quantize(x, mi=-3, ma=3):
    """io.loader.quantize at the viz scripts' [-3, 3] window (the reference
    scripts quantize thumbnails/overlays at 3 sigma, plot_2d.py:95)."""
    from cet_pick_tpu_torch.io.loader import quantize

    return quantize(x, mi=mi, ma=ma)


def cluster_embeddings(projs, n_cluster, ncentroids=256, niter=300,
                       seed=1234, device="cuda"):
    """k-means overclustering on ``device`` + spectral grouping of the
    centroids -> per-point labels (plot_2d.py:61-85). Returns (labels,
    centroids, assignment)."""
    from cet_pick_tpu_torch.ops import kmeans as kmeans_ops

    cluster = require("sklearn.cluster", COMMAND)
    ncentroids = min(ncentroids, len(projs))
    cents, assign, _ = kmeans_ops.kmeans(projs, k=ncentroids, iters=niter,
                                         seed=seed, device=device)
    spec = cluster.SpectralClustering(
        n_clusters=min(n_cluster, ncentroids), assign_labels="discretize",
        random_state=0,
    )
    spec.fit(cents)
    return spec.labels_[assign], cents, assign


def layout_2d(projs, mode="umap", num_neighbor=40, min_dist=0.5, seed=42,
              labels=None):
    """2D layout scaled to the unit square (plot_2d.py:112-120): umap where
    it is installed, else sklearn TSNE (the reference's --mode tsne)."""
    emb = None
    if mode == "umap":
        try:
            import umap

            proj = umap.UMAP(n_neighbors=num_neighbor, min_dist=min_dist,
                             random_state=seed)
            emb = proj.fit_transform(projs, y=labels)
        except ImportError:
            mode = "tsne"
    if emb is None:
        manifold = require("sklearn.manifold", COMMAND)
        perplexity = min(num_neighbor, max(2, len(projs) - 1))
        proj = manifold.TSNE(n_components=2, perplexity=perplexity,
                             random_state=seed, max_iter=1000)
        emb = proj.fit_transform(np.asarray(projs))
    lo, hi = emb.min(axis=0), emb.max(axis=0)
    return (emb - lo) / np.maximum(hi - lo, 1e-12)


def _pyplot():
    matplotlib = require("matplotlib", COMMAND)
    matplotlib.use("Agg")
    return require("matplotlib.pyplot", COMMAND)


def _thumbnail_plot(path, emb2d, patches, min_dist_vis, labels=None,
                    cmap: Optional[ColorMap2D] = None):
    """Thumbnail scatter with min-distance dedup (plot_2d.py:121-167,
    169-218)."""
    plt = _pyplot()
    osb = require("matplotlib.offsetbox", COMMAND)
    circle = require("matplotlib.patches", COMMAND).Circle
    image = require("PIL.Image", COMMAND)

    fig = plt.figure(figsize=(15, 15))
    ax = fig.add_subplot(1, 1, 1)
    shown = np.expand_dims(emb2d[0], axis=0)
    shown_idx = []
    for i in range(emb2d.shape[0]):
        dist = np.sum((emb2d[i] - shown) ** 2, 1)
        if np.min(dist) < min_dist_vis:
            continue
        shown = np.r_[shown, [emb2d[i]]]
        shown_idx.append(i)
    thumbnail_size = 75
    bbox_props = dict(boxstyle="round,pad=0.1", fc="white", alpha=1.0,
                      ec="#0000ff", lw=2)
    for idx in shown_idx:
        img = patches[idx]
        img = (img - img.mean()) / max(img.std(), 1e-12)
        img = _quantize(img)
        img = np.array(image.fromarray(img).resize(
            (thumbnail_size, thumbnail_size), image.BILINEAR))
        ax.add_artist(osb.AnnotationBbox(
            osb.OffsetImage(img, cmap=plt.cm.gray), emb2d[idx], pad=0.2,
        ))
        if labels is None and cmap is not None:
            color = cmap(emb2d[idx][0], emb2d[idx][1]) / 255
            ax.add_patch(circle(emb2d[idx], 0.03, fill=True, color=color))
        elif labels is not None:
            ax.text(emb2d[idx][0] - 0.025, emb2d[idx][1] + 0.020,
                    f"{int(labels[idx])}", color="#0000ff",
                    fontweight="bold", fontsize=15, bbox=bbox_props)
    ax.set_aspect("equal", adjustable="box")
    fig.savefig(path, bbox_inches="tight", pad_inches=0.1)
    plt.close(fig)


def plot_2d(npz_path, out_path, n_cluster, num_neighbor=40, mode="umap",
            seed=42, host=7000, min_dist_umap=0.5, min_dist_vis=0.01,
            save_imgs=True, colormap="ziegler", device="cuda"):
    """The whole plot_2d flow, the k-means on ``device``; returns the
    parquet path (plot_2d.py:55-218)."""
    plt = _pyplot()
    pd = require("pandas", COMMAND)
    require("pyarrow", COMMAND)  # DataFrame.to_parquet's engine

    data = np.load(npz_path)
    patches = data["subvol"]
    projs = data["pred"]  # the reference clusters the *pred* vectors (:58)
    names = data["name"]
    coords = data["coords"]
    os.makedirs(out_path, exist_ok=True)
    cmap = ColorMap2D(colormap)

    final_lbs, _, _ = cluster_embeddings(projs, n_cluster, seed=1234,
                                         device=device)
    print(f"Actual number of clusters is: {len(set(final_lbs.tolist()))}")

    # thumbnails + parquet for the interactive session
    img_dir = os.path.join(out_path, "imgs")
    os.makedirs(img_dir, exist_ok=True)
    rela = f"http://localhost:{host}/imgs/"
    all_paths = []
    for i in range(patches.shape[0]):
        fname = f"{i}.png"
        all_paths.append(os.path.join(rela, fname))
        if save_imgs:
            img = patches[i]
            # vol-mode subvols are (D, H, W): thumbnail the central z-slice
            img = img[img.shape[0] // 2] if img.ndim == 3 else img
            plt.imsave(os.path.join(img_dir, fname), img, cmap="gray")
    df = pd.DataFrame({
        "name": list(names),
        "coord": [[str(v) for v in c] for c in coords],
        "embeddings": [list(p) for p in projs],
        "label": list(final_lbs),
        "image": all_paths,
    })
    parquet = os.path.join(out_path, "interactive_info_parquet.gzip")
    df.to_parquet(parquet, compression="gzip")

    # unsupervised layout + colors
    emb2d = layout_2d(projs, mode=mode, num_neighbor=num_neighbor,
                      min_dist=min_dist_umap, seed=seed)
    colors = cmap.sample_many(emb2d)
    np.save(os.path.join(out_path, "all_colors.npy"), colors)
    patches2d = (patches[:, patches.shape[1] // 2]
                 if patches.ndim == 4 else patches)
    _thumbnail_plot(os.path.join(out_path, "2d_visualization_out.webp"),
                    emb2d, patches2d, min_dist_vis, cmap=cmap)

    # label-supervised layout
    emb2d_lb = layout_2d(projs, mode=mode, num_neighbor=num_neighbor,
                         min_dist=min_dist_umap, seed=seed, labels=final_lbs)
    _thumbnail_plot(os.path.join(out_path, "2d_visualization_labels.webp"),
                    emb2d_lb, patches2d, min_dist_vis, labels=final_lbs)
    return parquet
