"""FLOPs of the dilated-bottleneck U-Net, conv by conv, from the
configuration's widths (``Segmentation/train_adipose_unet_v3.py:660-758``).

A conv of k x k taps from cin to cout channels over an h x w map costs
k * k * cin * cout multiply-adds a pixel; a FLOP is half a multiply-add.
Pools, upsampling, concatenation, ReLU, bias and the softmax are not
counted: they are not the model's arithmetic.
"""

from __future__ import annotations


def conv_layers(init_nb: int, n_rates: int, deep_supervision: bool):
    """(name, cin, cout, k, scale) of every conv, ``scale`` being the
    divisor of the tile side at which it runs."""
    nb = init_nb
    layers = [("down1_conv1", 1, nb, 3, 1), ("down1_conv2", nb, nb, 3, 1),
              ("down2_conv1", nb, 2 * nb, 3, 2), ("down2_conv2", 2 * nb, 2 * nb, 3, 2),
              ("down3_conv1", 2 * nb, 4 * nb, 3, 4), ("down3_conv2", 4 * nb, 4 * nb, 3, 4)]
    for i in range(n_rates):
        layers.append((f"dilate{i + 1}", 4 * nb if i == 0 else 8 * nb, 8 * nb, 3, 8))
    for level, feat, below, scale in ((3, 4 * nb, 8 * nb, 4), (2, 2 * nb, 4 * nb, 2),
                                      (1, nb, 2 * nb, 1)):
        layers += [(f"up{level}_conv1", below, feat, 3, scale),
                   (f"up{level}_conv2", 2 * feat, feat, 3, scale),
                   (f"up{level}_conv3", feat, feat, 3, scale)]
    layers.append(("output_softmax", nb, 2, 1, 1))
    if deep_supervision:
        layers += [("aux_out1", 4 * nb, 1, 1, 4), ("aux_out2", 2 * nb, 1, 1, 2)]
    return layers


def forward_macs(config: dict, size: int, deep_supervision: bool = False) -> float:
    """Multiply-adds of one forward pass over one size x size tile."""
    return float(sum(k * k * cin * cout * (size // scale) ** 2
                     for _, cin, cout, k, scale in conv_layers(
                         config["init_nb"], len(config["dilation_rates"]), deep_supervision)))


def forward_flops(config: dict, size: int, deep_supervision: bool = False) -> float:
    return 2.0 * forward_macs(config, size, deep_supervision)
