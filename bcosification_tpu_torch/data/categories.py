"""Category name lists (a copy of ``bcosification_tpu/data/categories.py``;
the ImageNet and CIFAR10 lists and the ImageNet class index are read from
``data/assets/``, copies of the JAX package's files)."""
import json
from pathlib import Path

_ASSETS = Path(__file__).parent / "assets"

with open(_ASSETS / "categories.json") as f:
    _cats = json.load(f)

IMAGENET_CATEGORIES = _cats["IMAGENET_CATEGORIES"]
CIFAR10_CATEGORIES = _cats["CIFAR10_CATEGORIES"]

VOC_CATEGORIES = [
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]

FASHION_MNIST_CATEGORIES = [
    "T-shirt/top", "Trouser", "Pullover", "Dress", "Coat",
    "Sandal", "Shirt", "Sneaker", "Bag", "Ankle boot",
]

STL10_CATEGORIES = [
    "airplane", "bird", "car", "cat", "deer",
    "dog", "horse", "monkey", "ship", "truck",
]

CIFAR100_CATEGORIES = [
    "apple", "aquarium_fish", "baby", "bear", "beaver", "bed", "bee",
    "beetle", "bicycle", "bottle", "bowl", "boy", "bridge", "bus",
    "butterfly", "camel", "can", "castle", "caterpillar", "cattle", "chair",
    "chimpanzee", "clock", "cloud", "cockroach", "couch", "crab",
    "crocodile", "cup", "dinosaur", "dolphin", "elephant", "flatfish",
    "forest", "fox", "girl", "hamster", "house", "kangaroo", "keyboard",
    "lamp", "lawn_mower", "leopard", "lion", "lizard", "lobster", "man",
    "maple_tree", "motorcycle", "mountain", "mouse", "mushroom", "oak_tree",
    "orange", "orchid", "otter", "palm_tree", "pear", "pickup_truck",
    "pine_tree", "plain", "plate", "poppy", "porcupine", "possum", "rabbit",
    "raccoon", "ray", "road", "rocket", "rose", "sea", "seal", "shark",
    "shrew", "skunk", "skyscraper", "snail", "snake", "spider", "squirrel",
    "streetcar", "sunflower", "sweet_pepper", "table", "tank", "telephone",
    "television", "tiger", "tractor", "train", "trout", "tulip", "turtle",
    "wardrobe", "whale", "willow_tree", "wolf", "woman", "worm",
]


def imagenet_class_index():
    """{"<index>": [wnid, name]} of the 1000 ImageNet classes."""
    with open(_ASSETS / "imagenet_class_index.json") as f:
        return json.load(f)
