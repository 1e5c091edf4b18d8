"""The plate loop (``drivers/plate.py``) for plates projected by focus
stacking, each well to its own depth, and analysed inside a fitted well
mask (``run_plate``'s ``proj_method="fs"``, ``detect_well``, ``z_counts``).

Set-up and the window are the plate driver's. Set-up also wraps two
names the pipeline calls: for the plates drawn for the check it keeps
each projection that ``plate_zproj_masked`` made (a copy on the device)
and each mask that ``make_well_mask`` fitted, with the image it fitted it
on (a host copy of what the call already returns).

The check is the plate driver's, with the reference given each well's
stack trimmed to the traffic's depth and what was kept to judge
(``reference/segment_fs_well.py``):

- ``proj_gap``: the share of pixels by which the program's projection of
  the well differs from the reference's focus stacking over the well's
  depth;
- ``mask_gap``: the share of pixels by which the program's well mask and
  shrunken mask differ from the nearest mask that the reference's fit
  allows (the ties that rounding decides resolved either way); 1 for a
  well with no mask;
- the patch probabilities, the area band and the host tail then follow
  that mask of the reference's (the fit is a discontinuous function of
  its input, so the rest is judged from the allowed mask the program
  took; the fit itself is judged by ``mask_gap``).

Under the control the GMM of the well's pixels runs in bfloat16.
"""

from __future__ import annotations

import numpy as np

from perfbench.drivers import plate


class Driver(plate.Driver):
    def setup(self) -> None:
        from tmat_torch.tools import plate_pipeline

        self.pipeline = plate_pipeline
        self._make_well_mask = plate_pipeline.make_well_mask
        self._zproj = plate_pipeline.plate_zproj_masked
        plate_pipeline.make_well_mask = self._kept_mask
        plate_pipeline.plate_zproj_masked = self._kept_zproj
        super().setup()

    def _keep(self, key: str, value) -> None:
        if self.recording is not None:
            self.kept.setdefault(self.recording_plate, {"masks": [], "projections": []})[key].append(value)

    def _kept_mask(self, img, *args, **kwargs):
        out = self._make_well_mask(img, *args, **kwargs)
        self._keep("masks", (np.array(img), *out))
        return out

    def _kept_zproj(self, stacks, *args, **kwargs):
        out = self._zproj(stacks, *args, **kwargs)
        for proj in out:
            self._keep("projections", proj.detach().clone())
        return out

    def release(self) -> None:
        self.pipeline.make_well_mask = self._make_well_mask
        self.pipeline.plate_zproj_masked = self._zproj
        super().release()
