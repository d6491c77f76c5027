"""The beta-embedding scatter plot and the recon-error histogram of
``-m infer``.

Counterpart of ``behavior_driven_video_synthesis_tpu/viz/embedding.py``
(``embed_2d`` :15-28, ``plot_embedding`` :31-55, ``make_hist`` :58-71).
The embedding is PCA by SVD (``umap`` is installed on neither machine:
``"auto"`` takes PCA, ``"umap"`` raises ``ImportError``, as in JAX).  The
plots are drawn with cv2 and numpy, not matplotlib, at the size the JAX
package saves them (5 x 5 and 5 x 3 inches at 120 dpi), and returned as
RGB images.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .videos import _cv2, write_image

DPI = 120
# matplotlib's "tab10" colours, RGB
TAB10 = np.array([(31, 119, 180), (255, 127, 14), (44, 160, 44),
                  (214, 39, 40), (148, 103, 189), (140, 86, 75),
                  (227, 119, 194), (127, 127, 127), (188, 189, 34),
                  (23, 190, 207)], np.uint8)
_MARGIN = (0.125, 0.11, 0.1, 0.12)     # left, bottom, right, top


def embed_2d(latents: np.ndarray, method: str = "auto") -> np.ndarray:
    """(N, D) -> (N, 2): UMAP when the package is there, else PCA."""
    latents = np.asarray(latents, np.float64)
    if method in ("auto", "umap"):
        try:
            import umap  # type: ignore

            return umap.UMAP(n_components=2).fit_transform(latents)
        except ImportError:
            if method == "umap":
                raise
    centered = latents - latents.mean(0)
    _, _, vt = np.linalg.svd(centered, full_matrices=False)
    return centered @ vt[:2].T


def _axes(width: int, height: int, title: str, colorbar: bool = False):
    """(canvas, (x0, y0, x1, y1) of the plot area) with the frame and the
    title drawn."""
    c = _cv2()
    img = np.full((height, width, 3), 255, np.uint8)
    left, bottom, right, top = _MARGIN
    x1 = int(width * (1 - right - (0.12 if colorbar else 0)))
    box = (int(width * left), int(height * top), x1,
           int(height * (1 - bottom)))
    c.rectangle(img, box[:2], box[2:], (0, 0, 0), 1)
    (tw, _), _ = c.getTextSize(title, c.FONT_HERSHEY_SIMPLEX, 0.6, 1)
    c.putText(img, title, ((box[0] + box[2] - tw) // 2, box[1] - 12),
              c.FONT_HERSHEY_SIMPLEX, 0.6, (0, 0, 0), 1, c.LINE_AA)
    return img, box


def _to_box(v: np.ndarray, lo: float, hi: float, a: int, b: int):
    span = hi - lo if hi > lo else 1.0
    return a + (v - lo) / span * (b - a)


def plot_embedding(latents: np.ndarray, labels: Optional[np.ndarray] = None,
                   out_path: Optional[str] = None) -> np.ndarray:
    """The 2-D embedding's scatter, coloured by label (tab10 over the
    labels' range, with a colour bar); returns the RGB image and writes
    it as a PNG when ``out_path`` is given."""
    c = _cv2()
    emb = embed_2d(latents)
    img, (x0, y0, x1, y1) = _axes(5 * DPI, 5 * DPI,
                                  "behavior-latent embedding",
                                  colorbar=labels is not None)
    pad = 0.05 * (emb.max(0) - emb.min(0) + 1e-12)
    lo, hi = emb.min(0) - pad, emb.max(0) + pad
    xs = _to_box(emb[:, 0], lo[0], hi[0], x0, x1)
    ys = _to_box(emb[:, 1], lo[1], hi[1], y1, y0)
    if labels is None:
        colors = np.repeat(TAB10[:1], len(emb), axis=0)
    else:
        lab = np.asarray(labels, np.float64).reshape(len(emb), -1)[:, 0]
        frac = _to_box(lab, lab.min(), lab.max(), 0, 1)
        colors = TAB10[np.minimum((frac * 10).astype(int), 9)]
        # the colour bar beside the plot area
        bx0, bx1 = x1 + int(0.04 * img.shape[1]), x1 + int(0.08 * img.shape[1])
        for i in range(10):
            ya = int(_to_box(i + 1, 0, 10, y1, y0))
            yb = int(_to_box(i, 0, 10, y1, y0))
            c.rectangle(img, (bx0, ya), (bx1, yb),
                        tuple(int(v) for v in TAB10[i]), -1)
        c.rectangle(img, (bx0, y0), (bx1, y1), (0, 0, 0), 1)
    for x, y, col in zip(np.rint(xs).astype(int), np.rint(ys).astype(int),
                         colors):
        c.circle(img, (int(x), int(y)), 3, tuple(int(v) for v in col), -1,
                 c.LINE_AA)
    if out_path:
        write_image(img, out_path)
    return img


def make_hist(values: np.ndarray, out_path: Optional[str] = None,
              bins: int = 50, title: str = "per-sequence recon error"
              ) -> np.ndarray:
    """Histogram of ``values`` in ``bins`` bins; returns the RGB image and
    writes it as a PNG when ``out_path`` is given."""
    c = _cv2()
    counts, edges = np.histogram(np.asarray(values, np.float64).ravel(),
                                 bins=bins)
    img, (x0, y0, x1, y1) = _axes(5 * DPI, 3 * DPI, title)
    top = max(int(counts.max()), 1) * 1.05
    xs = _to_box(edges, edges[0], edges[-1], x0, x1)
    for n, xa, xb in zip(counts, xs[:-1], xs[1:]):
        if n:
            c.rectangle(img, (int(round(xa)), int(round(
                _to_box(n, 0, top, y1, y0)))), (int(round(xb)), y1),
                tuple(int(v) for v in TAB10[0]), -1)
    if out_path:
        write_image(img, out_path)
    return img
