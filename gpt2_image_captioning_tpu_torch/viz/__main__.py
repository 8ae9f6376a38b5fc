"""The results viewer's command line: ``python -m gpt2_image_captioning_tpu_torch.viz``
with the arguments of the repository's ``visualize_my_results.py``
(predictions + images dir + annotations → a web app at localhost:5151):

    python -m gpt2_image_captioning_tpu_torch.viz \\
        --predictions checkpoints/checkpoint_1/test_predictions_1.json \\
        --images-dir coco_data/val2014 \\
        --annotations coco_data/annotations/captions_val2014.json
"""

from __future__ import annotations

import argparse
import json

from gpt2_image_captioning_tpu_torch.viz import create_captioning_dataset, launch_app


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(prog="python -m gpt2_image_captioning_tpu_torch.viz",
                                description="Visualize generated captions vs references")
    p.add_argument("--predictions", required=True, help="results.json-style predictions")
    p.add_argument("--images-dir", required=True, help="directory with the images")
    p.add_argument("--annotations", required=True, help="COCO annotations JSON")
    p.add_argument("--metrics", default=None, help="optional per-image metrics JSON")
    p.add_argument("--compute-metrics", action="store_true",
                   help="compute per-image BLEU-4/ROUGE-L/CIDEr for the chips")
    p.add_argument("--port", type=int, default=5151)
    p.add_argument("--dataset-name", default="captioning-results")
    p.add_argument("--no-browser", action="store_true")
    args = p.parse_args(argv)

    metrics = None
    if args.metrics:
        with open(args.metrics) as f:
            metrics = {int(k): v for k, v in json.load(f).items()}
    elif args.compute_metrics:
        from gpt2_image_captioning_tpu_torch.evaluation.evaluate import per_image_metrics

        with open(args.predictions) as f:
            metrics = per_image_metrics(json.load(f), args.annotations)

    samples = create_captioning_dataset(
        args.predictions,
        args.images_dir,
        args.annotations,
        metrics=metrics,
        dataset_name=args.dataset_name,
    )
    launch_app(samples, args.images_dir, port=args.port, open_browser=not args.no_browser)


if __name__ == "__main__":
    main()
