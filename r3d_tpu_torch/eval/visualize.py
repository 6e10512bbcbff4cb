"""Visual artifacts (reference evaluation/make_gif*.py,
predict_utkinects.py:36-103 and :164-212, transformer.py:305-322).

Counterpart of ``r3d_tpu/eval/visualize.py``:

- ``render_anticipation_gif``: a GIF over a video's frames, the observed
  ones captioned with their label, the anticipated ones with the ground
  truth beside the prediction;
- ``tsne_plot``: a t-SNE scatter of embeddings;
- ``attention_map_plot``: a heat plot of one attention map.

matplotlib (Agg), imageio, PIL and sklearn are imported at call time, so
the port needs none of them elsewhere.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def render_anticipation_gif(
    image_paths: Sequence[str],
    gt_labels: Sequence[str],
    pred_labels: Sequence[str],
    out_path: str,
    observed_count: int,
    frame_duration: float = 5.0,
) -> str:
    """gt-vs-pred GIF (make_gif.py:36-100 pattern): observed frames captioned
    with their label, anticipated frames with 'GT | Pred' colored by
    correctness."""
    import imageio.v2 as imageio
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from PIL import Image

    frames = []
    for i, path in enumerate(image_paths):
        fig, ax = plt.subplots(figsize=(6, 6))
        try:
            ax.imshow(Image.open(path))
        except OSError:   # a missing or unreadable frame: a black square
            ax.imshow(np.zeros((10, 10, 3), np.uint8))
        ax.axis("off")
        if i < observed_count:
            fig.text(0.5, 0.1, gt_labels[i], ha="center", fontsize=14,
                     fontweight="bold")
        else:
            j = i
            correct = gt_labels[j] == pred_labels[j]
            fig.text(
                0.5, 0.9, f"GT: {gt_labels[j]} | Pred: {pred_labels[j]}",
                color="blue" if correct else "red", ha="center", va="top",
                fontsize=12, fontweight="bold",
            )
        fig.canvas.draw()
        frame = np.asarray(fig.canvas.buffer_rgba())[..., :3]
        frames.append(frame)
        plt.close(fig)

    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    imageio.mimsave(out_path, frames, duration=frame_duration, loop=0)
    return out_path


def tsne_plot(
    embeddings: np.ndarray,
    out_path: str,
    labels: Optional[np.ndarray] = None,
    perplexity: float = 30.0,
    seed: int = 42,
) -> Optional[str]:
    """t-SNE scatter (predict_utkinects.py:164-212)."""
    if len(embeddings) < 2:
        return None
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from sklearn.manifold import TSNE

    if labels is None:
        labels = np.arange(len(embeddings))
    tsne = TSNE(
        n_components=2, perplexity=min(perplexity, max(len(embeddings) - 1, 1) / 3),
        random_state=seed,
    )
    pts = tsne.fit_transform(np.asarray(embeddings))
    uniq = np.unique(labels)
    cmap = plt.get_cmap("Set1", len(uniq))
    color_of = {l: cmap(i) for i, l in enumerate(uniq)}
    plt.figure(figsize=(8, 6))
    plt.scatter(pts[:, 0], pts[:, 1], c=[color_of[l] for l in labels], alpha=0.7)
    handles = [
        plt.Line2D([0], [0], marker="o", color=c, linestyle="", label=f"Class {l}")
        for l, c in color_of.items()
    ]
    plt.legend(handles=handles, title="Classes", bbox_to_anchor=(1.05, 1),
               loc="upper left")
    plt.title("t-SNE Visualization")
    plt.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    plt.savefig(out_path, dpi=150)
    plt.close()
    return out_path


def attention_map_plot(attn: np.ndarray, out_path: str, title: str = "Attention") -> str:
    """Heat plot of one attention map (transformer.py:305-322, re-enabled)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(12, 6))
    plt.imshow(np.asarray(attn), cmap="hot", aspect="auto")
    plt.colorbar()
    plt.title(title)
    plt.xlabel("Key position")
    plt.ylabel("Query position")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    plt.savefig(out_path, dpi=150)
    plt.close()
    return out_path
