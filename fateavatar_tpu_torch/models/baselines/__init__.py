"""The four baseline avatar families (GaussianAvatars, FlashAvatar,
SplattingAvatar, MonoGaussianAvatar)."""
