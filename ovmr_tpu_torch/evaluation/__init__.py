from .evaluator import EVALUATOR_REGISTRY, Classification, build_evaluator

__all__ = ["EVALUATOR_REGISTRY", "Classification", "build_evaluator"]
