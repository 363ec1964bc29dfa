"""PNG (and other image) files to and from numpy arrays, through Pillow.

The JAX package reads and writes frames with imageio, whose PNG plugin is
Pillow; the port calls Pillow itself and needs no imageio. Both give the
same uint8 arrays: HxWx3 for RGB files, HxW for greyscale, palette images
expanded as imageio expands them. Pillow is imported where a file is read
or written.
"""

from __future__ import annotations

import numpy as np


def imread(path: str) -> np.ndarray:
    """The image in `path` as a uint8 array."""
    from PIL import Image

    with Image.open(path) as im:
        if im.mode == "P":
            im = im.convert("RGBA" if "transparency" in im.info else "RGB")
        return np.asarray(im).copy()


def imwrite(path: str, array: np.ndarray) -> None:
    """Write the uint8 array (HxW or HxWxC) to `path`; the extension names
    the format."""
    from PIL import Image

    Image.fromarray(np.ascontiguousarray(array)).save(path)
