"""Volume-to-surface projection and volume masking (twin of
litcoder_core_tpu/brain_projection/project.py).

Host numpy, run once per subject and then cached: the card sees only the
(time, vertices) matrices these produce. nibabel and nilearn are imported
where they are used, so the rest of the package works without them;
VolumeProcessor's masking and flattening is one numpy gather.
"""

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np


@dataclass
class SurfaceData:
    """Per-hemisphere and combined surface time series."""

    left_hemisphere: np.ndarray
    right_hemisphere: np.ndarray
    combined: np.ndarray  # (n_timepoints, n_left + n_right)


@dataclass
class VolumeData:
    """Flattened volume time series (n_timepoints, n_voxels)."""

    data: np.ndarray


class BaseBrainDataProcessor(ABC):
    """process_brain_data(4-D volume, affine) -> SurfaceData | VolumeData."""

    @abstractmethod
    def process_brain_data(
        self, volume_data: np.ndarray, affine: np.ndarray
    ) -> Union[SurfaceData, VolumeData]:
        raise NotImplementedError


class SurfaceProcessor(BaseBrainDataProcessor):
    """fsaverage surface projection with nilearn's vol_to_surf; needs
    nilearn and nibabel."""

    def __init__(self, mesh: str = "fsaverage5"):
        try:
            import nibabel as nib
            from nilearn import datasets, surface
        except ImportError as e:
            raise ImportError(
                "nilearn and nibabel are required for surface projection. "
                "Install with: pip install nilearn nibabel"
            ) from e
        self._surface = surface
        self._nib = nib
        self.fsaverage = datasets.fetch_surf_fsaverage(mesh=mesh)
        self.mesh_left = surface.load_surf_mesh(self.fsaverage["pial_left"])
        self.mesh_right = surface.load_surf_mesh(self.fsaverage["pial_right"])

    def process_brain_data(self, volume_data: np.ndarray,
                           affine: np.ndarray) -> SurfaceData:
        """Each timepoint's volume projected onto both hemispheres."""
        n_timepoints = volume_data.shape[3]
        left = np.zeros((n_timepoints, self.mesh_left[0].shape[0]))
        right = np.zeros((n_timepoints, self.mesh_right[0].shape[0]))
        for t in range(n_timepoints):
            img_t = self._nib.Nifti1Image(volume_data[:, :, :, t], affine)
            left[t, :] = self._surface.vol_to_surf(img_t, self.mesh_left)
            right[t, :] = self._surface.vol_to_surf(img_t, self.mesh_right)
        return SurfaceData(left, right, np.column_stack((left, right)))


class VolumeProcessor(BaseBrainDataProcessor):
    """Volume masking and flattening: (T, n_masked) or (T, n_voxels)."""

    def __init__(self, mask_path: Optional[str] = None, mask=None):
        self.mask = None
        if mask is not None:
            self.mask = np.asarray(mask, dtype=bool)
        elif mask_path is not None:
            import nibabel as nib

            self.mask = nib.load(mask_path).get_fdata().astype(bool)

    def process_brain_data(self, volume_data: np.ndarray,
                           affine: np.ndarray) -> VolumeData:
        n_timepoints = volume_data.shape[3]
        if self.mask is not None:
            if self.mask.shape != volume_data.shape[:3]:
                raise ValueError(
                    f"Mask shape {self.mask.shape} does not match volume "
                    f"shape {volume_data.shape[:3]}"
                )
            return VolumeData(data=volume_data[self.mask].T)
        n_voxels = int(np.prod(volume_data.shape[:3]))
        return VolumeData(data=volume_data.reshape(n_voxels, n_timepoints).T)
