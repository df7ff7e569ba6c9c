"""Front end of the port: framing, MFCC (through the fused CUDA kernel),
filterbank, spectrogram, PLP, deltas."""

from old_kaldi_git_tpu_torch.feat.compute import (  # noqa: F401
    Fbank,
    FbankOptions,
    Mfcc,
    MfccOptions,
    Plp,
    PlpOptions,
    Spectrogram,
    SpectrogramOptions,
    dct_matrix,
    lifter_coeffs,
)
from old_kaldi_git_tpu_torch.feat.functions import (  # noqa: F401
    DeltaFeaturesOptions,
    compute_deltas,
    delta_filters,
)
from old_kaldi_git_tpu_torch.feat.mel import MelBanksOptions, mel_banks_matrix  # noqa: F401
from old_kaldi_git_tpu_torch.feat.window import (  # noqa: F401
    FrameExtractionOptions,
    extract_frames,
    feature_window,
    frame_start_indices,
    num_frames,
)
