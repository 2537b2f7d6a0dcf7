"""Model zoo of the PyTorch port: the dense decoder family (``lm``), and the
paper's own ResNet-50/101/152 (``resnet``) and ViT (``vit``)."""
