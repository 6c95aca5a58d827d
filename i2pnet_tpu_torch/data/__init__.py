"""The data layer of the port (port of ``i2pnet_tpu/data``): the batch
pipeline and every protocol's loader: KITTI large-range, KITTI odometry
small-range (the CMR protocol), nuScenes small- and large-range, and the
KITTI raw online-calibration and RGGNet loaders. h5py (the local maps),
PIL (nuScenes' camera frames) and cv2 (the raw PNGs) are imported only
when a sample is read."""

from i2pnet_tpu_torch.data.kitti_large_range import KittiLargeRangeDataset
from i2pnet_tpu_torch.data.kitti_odometry_cmr import KittiOdometryCMRDataset
from i2pnet_tpu_torch.data.kitti_raw_calib import KittiRawCalibDataset, KittiRGGDataset
from i2pnet_tpu_torch.data.nuscenes import NuScenesCMRDataset, NuScenesLargeRangeDataset
from i2pnet_tpu_torch.data.pipeline import BatchLoader, collate, prefetch_to_device

__all__ = ["BatchLoader", "KittiLargeRangeDataset", "KittiOdometryCMRDataset",
           "KittiRawCalibDataset", "KittiRGGDataset", "NuScenesCMRDataset",
           "NuScenesLargeRangeDataset", "collate", "prefetch_to_device"]
