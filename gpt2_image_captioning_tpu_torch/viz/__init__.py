from gpt2_image_captioning_tpu_torch.viz.server import create_captioning_dataset, launch_app  # noqa: F401
