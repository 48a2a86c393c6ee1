from .aggregates import iqr_interval, quantile
from .errors import UserError
from .logging import setup_logger
from .run_names import create_run_name
from .seeding import filename_to_image_seed, seed_everything

__all__ = ["UserError", "setup_logger", "create_run_name",
           "filename_to_image_seed", "seed_everything", "quantile",
           "iqr_interval"]
