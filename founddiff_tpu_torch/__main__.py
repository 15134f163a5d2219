"""``python -m founddiff_tpu_torch``: the command line of :mod:`founddiff_tpu_torch.cli`."""

from founddiff_tpu_torch.cli import main

if __name__ == "__main__":
    main()
