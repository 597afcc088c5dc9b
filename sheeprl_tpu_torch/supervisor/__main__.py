"""``python -m sheeprl_tpu_torch.supervisor <overrides>``: supervise a
training run of the port."""

from sheeprl_tpu_torch.supervisor.supervise import main

if __name__ == "__main__":
    main()
