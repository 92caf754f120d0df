from .tokens import RepoTokenDataset, SyntheticTokens

__all__ = ["RepoTokenDataset", "SyntheticTokens"]
