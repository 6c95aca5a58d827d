"""The data layer of the port (port of ``i2pnet_tpu/data``): the batch
pipeline and the KITTI large-range loader. The loaders that read h5 maps,
PNGs or nuScenes images (h5py, cv2, PIL) are not ported yet."""

from i2pnet_tpu_torch.data.kitti_large_range import KittiLargeRangeDataset
from i2pnet_tpu_torch.data.pipeline import BatchLoader, collate, prefetch_to_device

__all__ = ["BatchLoader", "KittiLargeRangeDataset", "collate", "prefetch_to_device"]
