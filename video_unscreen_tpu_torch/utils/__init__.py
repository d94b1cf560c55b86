"""Host utilities: file I/O, visualization, checkpoints and device
selection."""

from .fileio import (read_txt_list, write_txt_list, parallel_read_img,
                     read_gray, save_img, save_video)  # noqa: F401
from .video import get_frame_count, get_frame_size  # noqa: F401
from .visualize import fuse_fgbg  # noqa: F401
from .checkpoint import (load_iseg, load_matting_unet, load_stm,  # noqa: F401
                         save_stm)
