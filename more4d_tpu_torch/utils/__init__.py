from .artifacts import (load_pointcloud_txt, make_grid, read_mask_video,
                        read_video_frames, save_pointcloud_txt,
                        save_videos_grid)
from .metrics import MetricsLogger

__all__ = ["MetricsLogger", "make_grid", "save_videos_grid",
           "read_video_frames", "read_mask_video", "save_pointcloud_txt",
           "load_pointcloud_txt"]
