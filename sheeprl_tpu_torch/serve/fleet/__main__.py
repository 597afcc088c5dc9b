"""``python -m sheeprl_tpu_torch.serve.fleet checkpoint_path=<run-dir> [overrides...]``"""

from sheeprl_tpu_torch.cli import serve_fleet

if __name__ == "__main__":
    serve_fleet()
