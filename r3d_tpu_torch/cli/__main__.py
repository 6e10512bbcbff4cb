"""``python -m r3d_tpu_torch.cli --config utkinects --data_root DIR [--cpu] ...``"""

from r3d_tpu_torch.cli.opts import run_from_argv

if __name__ == "__main__":
    run_from_argv("utkinects")
