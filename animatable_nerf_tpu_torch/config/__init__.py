from .config import Config, default_config, load_config, parse_cli

__all__ = ["Config", "default_config", "load_config", "parse_cli"]
