from .saliency import sobel_locations, unet_saliency

__all__ = ["sobel_locations", "unet_saliency"]
