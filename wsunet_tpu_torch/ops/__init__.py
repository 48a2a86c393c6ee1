from .filters import (NAMED_FILTERS, NAMED_FILTERS_2D, conv2d_valid,
                      filter_predict, filter_residuals, get_coefficients,
                      taps_to_kernel2d)
from .fused_reflect_conv import (conv3x3_reflect_fused,
                                 conv3x3_reflect_fused_plain)
from .fused_ws import ws_attack_fused, ws_attack_fused_plain
from .reflect_conv import conv3x3_reflect_borderfix
from .hill import hill_cost
from .ws import (lsb_flip_u8, ws_attack, ws_attack_sca, ws_estimate_inloss,
                 ws_estimate_unet, ws_weights)

__all__ = [
    "NAMED_FILTERS",
    "NAMED_FILTERS_2D",
    "conv2d_valid",
    "conv3x3_reflect_borderfix",
    "conv3x3_reflect_fused",
    "conv3x3_reflect_fused_plain",
    "filter_predict",
    "filter_residuals",
    "get_coefficients",
    "hill_cost",
    "taps_to_kernel2d",
    "ws_attack_fused",
    "ws_attack_fused_plain",
    "lsb_flip_u8",
    "ws_attack",
    "ws_attack_sca",
    "ws_estimate_inloss",
    "ws_estimate_unet",
    "ws_weights",
]
