from .correlation import pair_correlation, run_correlation
from .error_boxes import bucket_quantiles, run_error_boxes
from .contour import difference_image, plot_contour
from .saliency import saliency_patch, sobel_locations, unet_saliency

__all__ = [
    "run_correlation",
    "pair_correlation",
    "run_error_boxes",
    "bucket_quantiles",
    "difference_image",
    "plot_contour",
    "unet_saliency",
    "sobel_locations",
    "saliency_patch",
]
