"""Palette overlay for painted results (the port's copy of
``s4former_tpu/utils/palette.py``; reference: BaseSegmentor.show_result,
mmseg/models/segmentors/base.py:278-350)."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def colorize(seg: np.ndarray,
             palette: Optional[Sequence[Sequence[int]]]) -> np.ndarray:
    """Label map [h, w] -> RGB uint8 [h, w, 3] through ``palette``; labels
    past its end take its last colour."""
    if palette is None:
        # datasets registered without a PALETTE: seeded random colours,
        # like the reference's state.palette fallback (base.py:295-300)
        palette = np.random.RandomState(42).randint(
            0, 255, (256, 3)).tolist()
    pal = np.asarray(palette, np.uint8)
    seg = np.clip(seg, 0, len(pal) - 1)
    return pal[seg]


def paint_result(img_or_path, seg: np.ndarray,
                 palette: Optional[Sequence[Sequence[int]]],
                 opacity: float = 0.5) -> np.ndarray:
    """Blend the colourized segmentation onto the image (base.py:316-339);
    an image of another size is resized to the label map's first."""
    from s4former_tpu_torch.data.pipelines.transforms import (_pil_resize,
                                                              _read_rgb)
    img = _read_rgb(img_or_path) if isinstance(img_or_path, str) else \
        np.asarray(img_or_path)
    if img.shape[:2] != seg.shape:
        img = _pil_resize(img, (seg.shape[1], seg.shape[0]))
    color = colorize(seg, palette)
    out = img * (1 - opacity) + color * opacity
    return out.astype(np.uint8)
