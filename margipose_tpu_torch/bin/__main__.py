"""``python -m margipose_tpu_torch.bin``: the port's margipose CLI (see run_torch.sh)."""

from margipose_tpu_torch.bin import main

if __name__ == '__main__':
    main()
