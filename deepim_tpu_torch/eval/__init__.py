from deepim_tpu_torch.eval.evaluator import PoseEvaluator

__all__ = ["PoseEvaluator"]
