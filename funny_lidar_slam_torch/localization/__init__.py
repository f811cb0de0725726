from .localizer import LocalizationConfig, Localizer

__all__ = ["LocalizationConfig", "Localizer"]
