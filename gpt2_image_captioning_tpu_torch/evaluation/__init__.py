from gpt2_image_captioning_tpu_torch.evaluation.metrics import Bleu, Cider, Rouge  # noqa: F401
from gpt2_image_captioning_tpu_torch.evaluation.evaluate import (  # noqa: F401
    EvalMetrics,
    compute_caption_metrics,
    evaluate_captions,
    load_coco_references,
    save_eval_summary,
)
