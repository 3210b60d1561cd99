"""Render S2P-generated next frames into an augment dataset, producing the
``-rl.hdf5`` that offline RL reads:

    python -m s2p_tpu_torch.cli.generate_rl_dataset --dataset augment.hdf5 \
        --checkpoint cheetah_30.pth --output augment-rl.hdf5

A thin entry over ``s2p_tpu_torch.cli.generate_images``, which holds the
flags."""

from s2p_tpu_torch.cli.generate_images import main

if __name__ == "__main__":
    main()
