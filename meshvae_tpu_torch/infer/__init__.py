from .driver import InferenceEngine

__all__ = ["InferenceEngine"]
