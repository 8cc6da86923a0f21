"""Image normalization on the device — port of ``device_normalize`` from
``mnc_tpu/utils/blob.py``.  (``prep_im_for_blob`` needs ``cv2`` and is not
ported yet.)"""

from __future__ import annotations

import numpy as np
import torch

from mnc_tpu_torch.config import cfg


def device_normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8 canvases → mean-subtracted float32 on their device; float input
    passes through untouched, so the normalization is idempotent."""
    if images.dtype == torch.uint8:
        means = torch.as_tensor(np.asarray(cfg.PIXEL_MEANS, np.float32).reshape(-1),
                                device=images.device)
        return images.float() - means
    return images
