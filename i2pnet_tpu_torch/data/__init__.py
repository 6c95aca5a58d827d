"""The data layer of the port (port of ``i2pnet_tpu/data``): the batch
pipeline, the KITTI large-range loader and the KITTI raw online-calibration
loader. The loaders that read h5 maps or nuScenes images (h5py, PIL) are
not ported yet."""

from i2pnet_tpu_torch.data.kitti_large_range import KittiLargeRangeDataset
from i2pnet_tpu_torch.data.kitti_raw_calib import KittiRawCalibDataset
from i2pnet_tpu_torch.data.pipeline import BatchLoader, collate, prefetch_to_device

__all__ = ["BatchLoader", "KittiLargeRangeDataset", "KittiRawCalibDataset", "collate",
           "prefetch_to_device"]
