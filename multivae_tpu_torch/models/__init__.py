from .auto_model import AutoConfig, AutoModel
from .base import BaseModel, BaseMultiVAE, BaseMultiVAEConfig
from .cmvae import CMVAE, CMVAEConfig
from .crmvae import CRMVAE, CRMVAEConfig
from .cvae import CVAE, CVAEConfig
from .dmvae import DMVAE, DMVAEConfig
from .jmvae import JMVAE, JMVAEConfig
from .jnf import JNF, JNFConfig
from .joint_models import BaseJointModel, BaseJointModelConfig
from .mhvae import MHVAE, MHVAEConfig
from .mmvae import MMVAE, MMVAEConfig
from .mmvaePlus import MMVAEPlus, MMVAEPlusConfig
from .mopoe import MoPoE, MoPoEConfig
from .mvae import MVAE, MVAEConfig
from .mvtcae import MVTCAE, MVTCAEConfig
from .nexus import Nexus, NexusConfig
from .telbo import TELBO, TELBOConfig

__all__ = ["AutoConfig", "AutoModel", "BaseJointModel", "BaseJointModelConfig", "BaseModel", "BaseMultiVAE",
           "BaseMultiVAEConfig", "CMVAE", "CMVAEConfig", "CRMVAE", "CRMVAEConfig", "CVAE",
           "CVAEConfig", "DMVAE", "DMVAEConfig", "JMVAE", "JMVAEConfig", "JNF",
           "JNFConfig", "MHVAE", "MHVAEConfig", "MMVAE", "MMVAEConfig", "MMVAEPlus",
           "MMVAEPlusConfig", "MoPoE", "MoPoEConfig", "MVAE", "MVAEConfig", "MVTCAE",
           "MVTCAEConfig", "Nexus", "NexusConfig", "TELBO", "TELBOConfig"]
