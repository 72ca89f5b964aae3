from deepim_tpu_torch.utils.logger import create_logger, logger, set_logger_dir

__all__ = ["create_logger", "logger", "set_logger_dir"]
