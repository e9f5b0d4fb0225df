"""Synthetic-data GAN subsystem of the port: counterpart of `reid_tpu/gan`
(SURVEY.md section 2.6): the DCGAN / SNGAN generator, the discriminator
(plain, spectral, Wasserstein and VAE heads), the VAE-GAN, categorical
conditional BN, the EMA generator, k-means appearance grouping and the
LSRO loss for synthetic samples."""

from .driver import (generate_group_images, get_groups, load_gan_state,
                     make_resnet_embed_fn, sample_vaegan, save_gan_state,
                     train_gan_groups, train_lsro_baseline, train_vaegan)
from .models import (VAE, CategoricalConditionalBN, Discriminator, Generator,
                     SelfAttention)
from .train import (GANState, VGState, create_gan_state, ema_update,
                    generate_images, lsro_loss, make_dcgan_steps,
                    make_vaegan_steps)
