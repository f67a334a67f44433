from tdr_torch.rank.router import LanguageRouter, build_language_models

__all__ = ["LanguageRouter", "build_language_models"]
