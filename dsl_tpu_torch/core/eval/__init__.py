from dsl_tpu_torch.core.eval.coco_eval import COCOEval  # noqa: F401
