from .datasets import (dataset_dir, full_datasetname, load_dataset,
                       remotedatasets, testdataset)
from .generate import (add_impulse_noise, add_noise, affine_phantom,
                       circle_phantom, color_phantom, make_dataset)
from .png_io import (read_png_color, read_png_gray, write_png_color,
                     write_png_gray)

__all__ = ["testdataset", "load_dataset", "full_datasetname",
           "remotedatasets", "dataset_dir", "read_png_gray", "read_png_color",
           "write_png_gray", "write_png_color", "circle_phantom",
           "affine_phantom", "color_phantom", "add_noise",
           "add_impulse_noise", "make_dataset"]
