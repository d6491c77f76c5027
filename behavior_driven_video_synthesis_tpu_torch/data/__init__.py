def get_dataset(data_config):
    """The dataset class of the config's ``dataset`` field: human3.6m
    (human36m, h36m), deepfashion, market (market1501)."""
    name = data_config["dataset"].lower()
    if name in ("human3.6m", "human36m", "h36m"):
        from .human36m import Human36mDataset
        return Human36mDataset
    if name == "deepfashion":
        from .deepfashion import DeepFashionDataset
        return DeepFashionDataset
    if name in ("market", "market1501"):
        from .market import MarketDataset
        return MarketDataset
    raise ValueError(f"unknown dataset: {data_config['dataset']}")
