"""pyfasst_tpu_torch -- the PyTorch/CUDA port of pyfasst_tpu.

The JAX package (pyfasst_tpu) is the reference; this package keeps its
module layout and public names, so each module's counterpart is found under
the same path. It imports torch, numpy and scipy, never jax. Every E-step
runs in a hand-written CUDA kernel on an NVIDIA GPU (csrc/, built with
nvcc at first use): the instantaneous, convolutive and full-rank models
alike. On the CPU every operation runs in plain PyTorch.

    import pyfasst_tpu_torch

    model = pyfasst_tpu_torch.MultiChanNMFInst_FASST(
        "mixture.wav", nbComps=2, nbNMFComps=8, iter_num=500, device="cuda")
    model.estim_param_a_posteriori()
    model.separate_spat_comps("out_dir")

    # convolutive, DEMIX-initialized, full rank
    dm = pyfasst_tpu_torch.DEMIX("mixture.wav", wlen=1024)
    dm.comp_parameters(K=3)
    model = pyfasst_tpu_torch.MultiChanNMFConv(
        "mixture.wav", nbComps=3, nbNMFComps=6, spatial_rank=2,
        init_mixing=dm.mixing(513), device="cuda")

    # checkpoint / resume (the JAX package's .npz layout)
    model.estim_param_a_posteriori(checkpoint_path="run.npz",
                                   checkpoint_every=100)
    start = model.load_checkpoint("run.npz")

    # other front-ends, and the discrete-state and source-filter models
    model = pyfasst_tpu_torch.MultiChanNMFInst_FASST(
        "mixture.wav", transform=pyfasst_tpu_torch.ERBLetTransform(
            fs=44100, n_bands=48, device="cuda"), device="cuda")
    hmm = pyfasst_tpu_torch.MultiChanHMM("mixture.wav", nbStates=6,
                                         sparsity="HMM", device="cuda")

    # many clips at once, padded into frame buckets
    images, logliks = pyfasst_tpu_torch.batch_separate(
        Xs, make_params, pyfasst_tpu_torch.GEMConfig(niter=400),
        device="cuda")

    # a long recording in bounded memory: online GEM over blocks of 64
    # frames read off disk, then per-block separation and synthesis
    ys, info = pyfasst_tpu_torch.separate_streaming(
        "long.wav", J=2, K=8, frames_per_block=64, init="blind",
        out_dir="out_dir", device="cuda")

    # a mono mixture from the blind mixture-NMF init
    model = pyfasst_tpu_torch.MultiChanNMFInst_FASST(
        "mono.wav", nbComps=2, nbNMFComps=6, iter_num=300, device="cuda")
    model.estim_param_blind_mono()

Channel counts other than 2 (mono, 3 microphones) run through the general-I
engine, in plain PyTorch on either device: the JAX package has no kernel
for it either.
"""

__version__ = "0.1.0"

__all__ = [
    "AudioObject",
    "DEMIX",
    "ERBLetTransform",
    "ERBTransform",
    "FASST",
    "GEMConfig",
    "MelBank",
    "MinQTransfo",
    "MultiChanHMM",
    "MultiChanNMFConv",
    "MultiChanNMFInst_FASST",
    "MultiRateERBLet",
    "STFT",
    "SeparateLeadStereoTF",
    "StreamingSynthesis",
    "batch_separate",
    "batch_separate_files",
    "load_params",
    "multiChanSourceF0Filter",
    "online_block",
    "online_init",
    "run_gem_online",
    "save_params",
    "separate_streaming",
    "wpe_dereverb",
]

_LAZY = {
    "AudioObject": "pyfasst_tpu_torch.audio",
    "FASST": "pyfasst_tpu_torch.models",
    "MultiChanNMFInst_FASST": "pyfasst_tpu_torch.models",
    "MultiChanNMFConv": "pyfasst_tpu_torch.models",
    "MultiChanHMM": "pyfasst_tpu_torch.models",
    "multiChanSourceF0Filter": "pyfasst_tpu_torch.models",
    "SeparateLeadStereoTF": "pyfasst_tpu_torch.models.lead",
    "DEMIX": "pyfasst_tpu_torch.models",
    "STFT": "pyfasst_tpu_torch.tf",
    "StreamingSynthesis": "pyfasst_tpu_torch.tf",
    "ERBLetTransform": "pyfasst_tpu_torch.tf",
    "MultiRateERBLet": "pyfasst_tpu_torch.tf",
    "MinQTransfo": "pyfasst_tpu_torch.tf",
    "ERBTransform": "pyfasst_tpu_torch.tf",
    "MelBank": "pyfasst_tpu_torch.tf",
    "wpe_dereverb": "pyfasst_tpu_torch.tf",
    "GEMConfig": "pyfasst_tpu_torch.utils.config",
    "batch_separate": "pyfasst_tpu_torch.parallel.batch",
    "batch_separate_files": "pyfasst_tpu_torch.parallel.batch",
    "load_params": "pyfasst_tpu_torch.utils.checkpoint",
    "save_params": "pyfasst_tpu_torch.utils.checkpoint",
    "separate_streaming": "pyfasst_tpu_torch.models",
    "online_block": "pyfasst_tpu_torch.ops.online",
    "online_init": "pyfasst_tpu_torch.ops.online",
    "run_gem_online": "pyfasst_tpu_torch.ops.online",
}


def __getattr__(name):
    # Lazy top-level API: importing the package stays light (no torch import
    # until a model is touched).
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(
        f"module 'pyfasst_tpu_torch' has no attribute {name!r}")
