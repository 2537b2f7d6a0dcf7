"""Model zoo of the PyTorch port: the dense and MoE decoder families
(``lm``, whose MoE layers are ``moe``), and the paper's own
ResNet-50/101/152 (``resnet``) and ViT (``vit``)."""
