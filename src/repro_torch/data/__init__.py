from .tokens import SyntheticTokens

__all__ = ["SyntheticTokens"]
