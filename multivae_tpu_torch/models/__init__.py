from .base import BaseModel, BaseMultiVAE, BaseMultiVAEConfig
from .cmvae import CMVAE, CMVAEConfig
from .crmvae import CRMVAE, CRMVAEConfig
from .mmvae import MMVAE, MMVAEConfig
from .mmvaePlus import MMVAEPlus, MMVAEPlusConfig
from .mopoe import MoPoE, MoPoEConfig
from .mvae import MVAE, MVAEConfig
from .mvtcae import MVTCAE, MVTCAEConfig

__all__ = ["BaseModel", "BaseMultiVAE", "BaseMultiVAEConfig", "CMVAE", "CMVAEConfig",
           "CRMVAE", "CRMVAEConfig", "MMVAE", "MMVAEConfig", "MMVAEPlus",
           "MMVAEPlusConfig", "MoPoE", "MoPoEConfig", "MVAE", "MVAEConfig", "MVTCAE",
           "MVTCAEConfig"]
