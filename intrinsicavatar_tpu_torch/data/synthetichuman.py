"""SyntheticHuman(++) and RANA datasets: PeopleSnapshot's loader with GT
albedo and normal maps, a dilated-bbox ``valid_mask`` for the metrics and
per-frame relighting HDRIs (copy of the JAX package's
``data/synthetichuman.py``; images read by ``utils/image_io.py``, the
dilation by the samplers' scipy maximum filter, equal to ``cv2.dilate``).

The albedo maps may be PNG or EXR files; an EXR has no reader in the port
and raises, naming the format.  The ``valid_mask`` is taken from the mask
file at its own resolution, not the frame's downscaled one, as in the JAX
package.
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np

from intrinsicavatar_tpu_torch.data import register
from intrinsicavatar_tpu_torch.data.peoplesnapshot import PeopleSnapshotDataset
from intrinsicavatar_tpu_torch.data.samplers import _dilate
from intrinsicavatar_tpu_torch.utils.image_io import read_any, read_png


class _GtExtrasMixin:
    """GT albedo / normal / valid_mask / hdri on top of the image loader."""

    def _load_extras(self, idx, datum, flat_shape, sel_indices=None):
        if getattr(self, "albedo_lists", None):
            alb = read_any(self.albedo_lists[idx]).astype(np.float32)
            # the JAX package's rule as written: after the cast only the
            # range test can fire
            if alb.dtype == np.uint8 or alb.max() > 2.0:
                alb = alb / 255.0
            alb = alb.reshape(-1, 3)
            datum["albedo"] = alb[sel_indices] if sel_indices is not None \
                else alb
        if getattr(self, "normal_lists", None):
            nrm = read_png(self.normal_lists[idx]).astype(np.float32)
            nrm = nrm / 255.0 * 2.0 - 1.0
            nrm = nrm.reshape(-1, 3)
            datum["normal"] = nrm[sel_indices] if sel_indices is not None \
                else nrm
        if getattr(self, "hdri_map", None) and self.mode == "test":
            name = self.hdri_map.get(str(idx)) or self.hdri_map.get(
                os.path.basename(self.img_lists[idx]))
            if name:
                datum["hdri"] = read_any(os.path.join(
                    self.root, "hdri", name)).astype(np.float32)
        return datum

    def _init_extras(self, start, end, skip):
        self.albedo_lists = sorted(
            glob.glob(f"{self.root}/albedo/*.png")
            + glob.glob(f"{self.root}/albedo/*.exr"))[start:end:skip]
        self.normal_lists = sorted(
            glob.glob(f"{self.root}/normal/*.png"))[start:end:skip]
        hdri_json = os.path.join(self.root, "hdri_files.json")
        self.hdri_map = None
        if os.path.exists(hdri_json):
            with open(hdri_json) as f:
                self.hdri_map = json.load(f)


@register("synthetichuman")
class SyntheticHumanDataset(_GtExtrasMixin, PeopleSnapshotDataset):
    def __init__(self, config, split="train", mode="train", rng=None):
        super().__init__(config, split=split, mode=mode, rng=rng)
        opt = config.get("opt", {}).get(mode, {})
        self._init_extras(opt.get("start", 0), opt.get("end", 0) + 1,
                          opt.get("skip", 1))

    def __getitem__(self, idx):
        datum = super().__getitem__(idx)
        if self.mode != "train":
            datum = self._load_extras(idx, datum, None)
            # the metrics' bbox: the mask dilated by a 16 x 16 square
            msk = np.load(self.msk_lists[idx]).astype(np.uint8)
            m = _dilate(msk, 16)
            ys, xs = np.where(m > 0)
            valid = np.zeros(m.shape, bool)
            if len(ys):
                valid[ys.min():ys.max() + 1, xs.min():xs.max() + 1] = True
            datum["valid_mask"] = valid.reshape(-1)
        return datum


@register("rana")
class RanaDataset(SyntheticHumanDataset):
    """RANA: SyntheticHuman's extras (GT albedo / normal, per-frame HDRIs)
    with novel-pose relighting (`datasets/rana.py`)."""
