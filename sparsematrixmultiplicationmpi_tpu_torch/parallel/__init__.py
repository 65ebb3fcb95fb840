from .strategies import STRATEGIES, Auto, Sequential, Strategy, get_strategy

__all__ = ["STRATEGIES", "Auto", "Sequential", "Strategy", "get_strategy"]
