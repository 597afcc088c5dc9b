"""``python -m sheeprl_tpu_torch.serve checkpoint_path=<ckpt> [overrides...]``"""

from sheeprl_tpu_torch.cli import serve

if __name__ == "__main__":
    serve()
