from s2p_tpu_torch.gan.generator import (
    MATNorm,
    MATResBlock,
    PositionalEmbedding,
    S2PGenerator,
    SPADEGenerator,
    SPADENorm,
    label_onehot,
    resolution_chain,
)
from s2p_tpu_torch.gan.fast_inference import (
    fast_apply,
    fuse_fast_params,
    generate_rollout_fast,
    synthesize_fast,
    synthesize_style_fast,
)
from s2p_tpu_torch.gan.stylegan import StyleGANGenerator
from s2p_tpu_torch.gan.rollout import generate_rollout
from s2p_tpu_torch.gan.discriminator import MultiscaleDiscriminator, NLayerDiscriminator
from s2p_tpu_torch.gan.perceptual import (
    LPIPSMetric,
    PerceptualLoss,
    VGG16Features,
    VGG19Features,
    load_lpips_linear,
    load_torch_vgg16,
    load_torch_vgg19,
)
from s2p_tpu_torch.gan.inception import (
    InceptionV3Features,
    inception_fid_extractor,
    load_torch_inception_v3,
)
from s2p_tpu_torch.gan.losses import (
    GANLossConfig,
    feature_matching_loss,
    hinge_d_loss,
    hinge_g_loss,
)
from s2p_tpu_torch.gan.training import GANOptConfig, GANTrainer

__all__ = [
    "MATNorm",
    "MATResBlock",
    "PositionalEmbedding",
    "S2PGenerator",
    "SPADEGenerator",
    "SPADENorm",
    "label_onehot",
    "resolution_chain",
    "fast_apply",
    "fuse_fast_params",
    "generate_rollout_fast",
    "synthesize_fast",
    "synthesize_style_fast",
    "StyleGANGenerator",
    "generate_rollout",
    "MultiscaleDiscriminator",
    "NLayerDiscriminator",
    "VGG19Features",
    "VGG16Features",
    "PerceptualLoss",
    "LPIPSMetric",
    "load_lpips_linear",
    "load_torch_vgg16",
    "load_torch_vgg19",
    "InceptionV3Features",
    "inception_fid_extractor",
    "load_torch_inception_v3",
    "hinge_d_loss",
    "hinge_g_loss",
    "feature_matching_loss",
    "GANLossConfig",
    "GANTrainer",
    "GANOptConfig",
]
