"""Model zoo of the PyTorch port: the dense, MoE, SSM and hybrid decoder
families (``lm``, whose MoE layers are ``moe`` and recurrent blocks
``ssm``), the encoder-decoder family (``encdec``), and the paper's own
ResNet-50/101/152 (``resnet``) and ViT (``vit``)."""
