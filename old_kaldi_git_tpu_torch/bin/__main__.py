import sys

from old_kaldi_git_tpu_torch.bin.tools import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
