"""Vendored WordNet hypernym subgraph + Wu-Palmer similarity (a copy of
``vqacl_tpu/evaluation/taxonomy.py``).

The reference's NExT-QA evaluation scores open-ended answers with WUPS,
whose word similarity is WordNet Wu-Palmer (the ``get_wups`` imported
from the repo-absent ``metrix.py`` — VL-T5/nextqa/
nextqa_data.py:21,994-1008). A machine without a WordNet corpus (nltk's
data is a separate download) still scores it: this module vendors the
hypernym closure of a NExT-QA-typical answer vocabulary (people,
animals, vehicles, household objects, food, places, body parts, and
action nouns) transcribed from WordNet 3.0, and implements NLTK's
``wup_similarity`` algorithm over it:

    lcs   = common hypernym maximizing min-depth    (use_min_depth=True)
    depth = max_depth(lcs) + 1                       (longest root path)
    wup   = 2*depth / ((dist(a,lcs)+depth) + (dist(b,lcs)+depth))

For encoded senses the returned value equals NLTK's on the real corpus
(e.g. cat.n.01/dog.n.01 → 24/28 = 0.857142…). Coverage is the dominant
noun sense(s) per word; WordNet's full sense inventory (e.g. the slang
person-senses of "cat"/"dog") is intentionally out — values for covered
pairs are therefore a faithful-per-sense lower bound of the full
max-over-senses similarity. Extend ``_CHAINS``/``_EXTRA_PARENTS``/
``LEMMAS`` to widen coverage.
"""

from __future__ import annotations

import functools
import itertools
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Hypernym chains, written root-first (entity.n.01 is the unique noun
# root). Each chain asserts parent links along the path; diamond
# (multiple-inheritance) links are added in _EXTRA_PARENTS.
# ---------------------------------------------------------------------------

_CHAINS: List[List[str]] = [
    # -- upper ontology ------------------------------------------------
    ["entity.n.01", "physical_entity.n.01", "object.n.01", "whole.n.02",
     "living_thing.n.01", "organism.n.01"],
    ["physical_entity.n.01", "causal_agent.n.01", "person.n.01"],
    ["entity.n.01", "abstraction.n.06", "psychological_feature.n.01",
     "event.n.01", "act.n.02"],
    ["abstraction.n.06", "attribute.n.02"],
    ["physical_entity.n.01", "matter.n.03", "substance.n.07", "food.n.01"],
    ["whole.n.02", "artifact.n.01", "instrumentality.n.03"],
    # -- animals --------------------------------------------------------
    ["organism.n.01", "animal.n.01", "chordate.n.01", "vertebrate.n.01",
     "mammal.n.01", "placental.n.01", "carnivore.n.01", "canine.n.02",
     "dog.n.01"],
    ["carnivore.n.01", "feline.n.01", "cat.n.01"],
    ["carnivore.n.01", "bear.n.01"],
    ["placental.n.01", "ungulate.n.01", "odd-toed_ungulate.n.01",
     "equine.n.01", "horse.n.01"],
    ["ungulate.n.01", "even-toed_ungulate.n.01", "ruminant.n.01",
     "bovid.n.01", "cattle.n.01", "cow.n.01"],
    ["bovid.n.01", "sheep.n.01"],
    ["bovid.n.01", "goat.n.01"],
    ["even-toed_ungulate.n.01", "swine.n.01", "hog.n.03", "pig.n.01"],
    ["placental.n.01", "proboscidean.n.01", "elephant.n.01"],
    ["placental.n.01", "primate.n.02", "monkey.n.01"],
    ["placental.n.01", "rodent.n.01", "squirrel.n.01"],
    ["rodent.n.01", "mouse.n.01"],
    ["placental.n.01", "lagomorph.n.01", "leporid.n.01", "rabbit.n.01"],
    ["vertebrate.n.01", "bird.n.01"],
    ["bird.n.01", "aquatic_bird.n.01", "waterfowl.n.01", "duck.n.01"],
    ["bird.n.01", "gallinaceous_bird.n.01", "domestic_fowl.n.01",
     "chicken.n.02"],
    ["vertebrate.n.01", "aquatic_vertebrate.n.01", "fish.n.01"],
    ["vertebrate.n.01", "reptile.n.01", "diapsid.n.01", "snake.n.01"],
    ["reptile.n.01", "anapsid.n.01", "turtle.n.02"],
    ["animal.n.01", "domestic_animal.n.01"],
    ["feline.n.01", "big_cat.n.01", "tiger.n.02"],
    ["big_cat.n.01", "lion.n.01"],
    ["ruminant.n.01", "giraffe.n.01"],
    # -- people ----------------------------------------------------------
    ["person.n.01", "adult.n.01", "man.n.01"],
    ["person.n.01", "male.n.02", "boy.n.01"],
    ["adult.n.01", "woman.n.01"],
    ["person.n.01", "female.n.02", "girl.n.01"],
    ["person.n.01", "juvenile.n.01", "child.n.01"],
    ["child.n.01", "baby.n.01"],
    ["woman.n.01", "lady.n.01"],
    ["man.n.01", "guy.n.01"],
    # -- vehicles ---------------------------------------------------------
    ["instrumentality.n.03", "conveyance.n.03", "vehicle.n.01",
     "wheeled_vehicle.n.01", "self-propelled_vehicle.n.01",
     "motor_vehicle.n.01", "car.n.01"],
    ["motor_vehicle.n.01", "truck.n.01"],
    ["motor_vehicle.n.01", "motorcycle.n.01"],
    ["wheeled_vehicle.n.01", "bicycle.n.01"],
    ["wheeled_vehicle.n.01", "wagon.n.01", "cart.n.01"],
    ["self-propelled_vehicle.n.01", "locomotive.n.01"],
    ["vehicle.n.01", "craft.n.02", "vessel.n.02", "boat.n.01"],
    ["vessel.n.02", "ship.n.01"],
    ["craft.n.02", "aircraft.n.01", "heavier-than-air_craft.n.01",
     "airplane.n.01"],
    ["conveyance.n.03", "public_transport.n.01", "train.n.01"],
    ["public_transport.n.01", "bus.n.01"],
    # -- household / objects ----------------------------------------------
    ["instrumentality.n.03", "furnishing.n.02", "furniture.n.01",
     "seat.n.03", "chair.n.01"],
    ["seat.n.03", "sofa.n.01"],
    ["seat.n.03", "bench.n.01"],
    ["furniture.n.01", "table.n.02"],
    ["furniture.n.01", "bed.n.01"],
    ["instrumentality.n.03", "container.n.01", "vessel.n.03", "bottle.n.01"],
    ["vessel.n.03", "cup.n.01"],
    ["vessel.n.03", "bowl.n.01"],
    ["container.n.01", "box.n.01"],
    ["container.n.01", "bag.n.01"],
    ["container.n.01", "basket.n.01"],
    ["instrumentality.n.03", "device.n.01", "instrument.n.01"],
    ["device.n.01", "electronic_device.n.01", "television.n.02"],
    ["instrumentality.n.03", "equipment.n.01", "electronic_equipment.n.01",
     "telephone.n.01"],
    ["electronic_equipment.n.01", "camera.n.01"],
    ["equipment.n.01", "game_equipment.n.01", "ball.n.01"],
    ["instrumentality.n.03", "implement.n.01", "utensil.n.01",
     "kitchen_utensil.n.01"],
    ["implement.n.01", "eating_utensil.n.01", "spoon.n.01"],
    ["eating_utensil.n.01", "fork.n.01"],
    ["implement.n.01", "stick.n.01"],
    ["device.n.01", "musical_instrument.n.01", "stringed_instrument.n.01",
     "guitar.n.01"],
    ["musical_instrument.n.01", "percussion_instrument.n.01", "drum.n.01"],
    ["musical_instrument.n.01", "keyboard_instrument.n.01", "piano.n.01"],
    ["artifact.n.01", "creation.n.02", "product.n.02", "work.n.02",
     "publication.n.01", "book.n.01"],
    ["artifact.n.01", "plaything.n.01", "toy.n.03"],
    ["plaything.n.01", "swing.n.02"],
    ["artifact.n.01", "covering.n.02", "clothing.n.01", "garment.n.01",
     "hat.n.01"],
    ["garment.n.01", "shirt.n.01"],
    ["covering.n.02", "footwear.n.02", "shoe.n.01"],
    ["artifact.n.01", "structure.n.01", "building.n.01", "house.n.01"],
    ["structure.n.01", "area.n.05", "room.n.01", "kitchen.n.01"],
    ["room.n.01", "bedroom.n.01"],
    ["room.n.01", "bathroom.n.01"],
    ["artifact.n.01", "way.n.06", "road.n.01", "street.n.01"],
    ["artifact.n.01", "line.n.18", "cord.n.01", "rope.n.01"],
    # -- food ---------------------------------------------------------------
    ["food.n.01", "nutriment.n.01", "dish.n.02"],
    ["nutriment.n.01", "course.n.07", "dessert.n.01", "cake.n.03"],
    ["food.n.01", "produce.n.01", "edible_fruit.n.01", "apple.n.01"],
    ["edible_fruit.n.01", "banana.n.02"],
    ["edible_fruit.n.01", "orange.n.01"],
    ["food.n.01", "beverage.n.01", "milk.n.01"],
    ["beverage.n.01", "juice.n.01"],
    ["matter.n.03", "fluid.n.02", "liquid.n.01", "water.n.01"],
    ["food.n.02", "bread.n.01"],        # food.n.02 'solid food' — simplified
    ["substance.n.07", "food.n.02"],
    # -- places / nature -----------------------------------------------------
    ["object.n.01", "geological_formation.n.01", "shore.n.01", "beach.n.01"],
    ["object.n.01", "land.n.04", "island.n.01"],
    ["physical_entity.n.01", "thing.n.12", "part.n.03", "body_part.n.01"],
    ["body_part.n.01", "external_body_part.n.01", "extremity.n.05",
     "hand.n.01"],
    ["extremity.n.05", "foot.n.01"],
    ["external_body_part.n.01", "head.n.01"],
    ["external_body_part.n.01", "face.n.01"],
    ["body_part.n.01", "process.n.05", "hair.n.01"],
    ["extremity.n.05", "digit.n.01", "finger.n.01"],
    ["external_body_part.n.01", "limb.n.01", "leg.n.01"],
    ["limb.n.01", "arm.n.01"],
    ["object.n.01", "location.n.01", "region.n.03", "area.n.01",
     "grassland.n.01", "lawn.n.01"],
    ["area.n.01", "yard.n.02"],
    ["region.n.03", "tract.n.01", "park.n.02"],
    ["tract.n.01", "field.n.01"],
    ["tract.n.01", "playground.n.02"],
    ["artifact.n.01", "surface.n.01", "floor.n.01"],
    ["object.n.01", "land.n.02", "ground.n.01"],
    ["organism.n.01", "plant.n.02", "vascular_plant.n.01", "woody_plant.n.01",
     "tree.n.01"],
    ["vascular_plant.n.01", "herb.n.01", "grass.n.01"],
    ["plant.n.02", "flower.n.01"],
    ["artifact.n.01", "excavation.n.03", "pool.n.01", "swimming_pool.n.01"],
    ["structure.n.01", "platform.n.01", "stage.n.03"],
    # -- action nouns (answers like "playing", "dancing" reduce to these
    #    after the evaluator's normalization) -------------------------------
    ["act.n.02", "activity.n.01", "diversion.n.01", "play.n.01"],
    ["diversion.n.01", "game.n.01"],
    ["diversion.n.01", "dancing.n.01", "dance.n.01"],
    ["diversion.n.01", "sport.n.01", "swimming.n.01"],
    ["act.n.02", "action.n.01", "motion.n.06", "locomotion.n.02",
     "walk.n.05"],
    ["locomotion.n.02", "running.n.01", "run.n.07"],
    ["locomotion.n.02", "jumping.n.01", "jump.n.06"],
    ["activity.n.01", "work.n.01"],
    ["activity.n.01", "wrongdoing.n.02"],
    ["act.n.02", "speech_act.n.01", "utterance.n.01"],
    ["attribute.n.02", "property.n.02", "visual_property.n.01",
     "color.n.01"],
    ["motion.n.06", "gesture.n.02"],
    # -- round-3 widening: frequent NExT-QA answer vocabulary ---------------
    ["act.n.02", "consumption.n.01", "eating.n.01"],       # simplified place
    ["consumption.n.01", "drinking.n.01"],
    ["activity.n.01", "sitting.n.01"],                     # simplified
    ["activity.n.01", "standing.n.03"],                    # simplified
    ["act.n.02", "expression.n.03", "crying.n.02"],        # simplified
    ["expression.n.03", "laughter.n.01"],
    ["expression.n.03", "smile.n.01"],                     # simplified
    ["speech_act.n.01", "conversation.n.01"],
    ["sport.n.01", "contact_sport.n.01", "football.n.01"],
    ["football.n.01", "soccer.n.01"],
    ["sport.n.01", "court_game.n.01", "basketball.n.01"],
    ["court_game.n.01", "tennis.n.01"],
    ["diversion.n.01", "riding.n.01"],
    ["abstraction.n.06", "communication.n.02",
     "auditory_communication.n.01", "music.n.01", "vocal_music.n.01",
     "singing.n.01"],
    ["covering.n.02", "protective_covering.n.01", "shelter.n.02",
     "canopy.n.03", "umbrella.n.01"],
    ["protective_covering.n.01", "helmet.n.02"],
    ["plaything.n.01", "balloon.n.02"],
    ["plaything.n.01", "kite.n.03"],
    ["wheeled_vehicle.n.01", "skateboard.n.01"],
    ["wheeled_vehicle.n.01", "scooter.n.02"],
    ["wheeled_vehicle.n.01", "baby_buggy.n.01"],
    ["artifact.n.01", "obstruction.n.01", "barrier.n.01",
     "movable_barrier.n.01", "door.n.01"],
    ["barrier.n.01", "fence.n.01"],
    ["structure.n.01", "partition.n.01", "wall.n.01"],
    ["structure.n.01", "supporting_structure.n.01", "framework.n.03",
     "window.n.01"],
    ["way.n.06", "stairway.n.01"],
    ["device.n.01", "reflector.n.01", "mirror.n.01"],
    ["device.n.01", "source_of_illumination.n.01", "lamp.n.01"],
    ["device.n.01", "machine.n.01", "computer.n.01"],
    ["computer.n.01", "portable_computer.n.01", "laptop.n.01"],  # simplified
    ["device.n.01", "microphone.n.01"],                    # simplified
    ["device.n.01", "home_appliance.n.01", "refrigerator.n.01"],  # simplif.
    ["home_appliance.n.01", "microwave.n.02"],
    ["instrumentality.n.03", "furnishing.n.02", "curtain.n.01"],
    ["covering.n.02", "cloth_covering.n.01", "blanket.n.01"],
    ["artifact.n.01", "padding.n.01", "cushion.n.03", "pillow.n.01"],
    ["vessel.n.03", "glass.n.02"],
    ["artifact.n.01", "article.n.02", "tableware.n.01", "flatware.n.01",
     "plate.n.04"],
    ["implement.n.01", "edge_tool.n.01", "knife.n.01"],
    ["artifact.n.01", "ladder.n.01"],                      # simplified
    ["structure.n.01", "shelter.n.01", "tent.n.01"],
    ["instrument.n.01", "optical_instrument.n.01", "spectacles.n.01"],
    ["artifact.n.01", "fabric.n.01", "piece_of_cloth.n.01", "towel.n.01"],
    ["garment.n.01", "dress.n.01"],
    ["garment.n.01", "jacket.n.01"],
    ["garment.n.01", "coat.n.01"],
    ["garment.n.01", "trouser.n.01"],
    ["object.n.01", "natural_object.n.01", "rock.n.02"],
    ["natural_object.n.01", "celestial_body.n.01", "sun.n.01"],
    ["celestial_body.n.01", "moon.n.01"],
    ["object.n.01", "sky.n.01"],                           # simplified
    ["geological_formation.n.01", "natural_elevation.n.01",
     "mountain.n.01"],
    ["geological_formation.n.01", "natural_depression.n.01", "valley.n.01"],
    ["thing.n.12", "body_of_water.n.01", "river.n.01"],
    ["body_of_water.n.01", "lake.n.01"],
    ["body_of_water.n.01", "sea.n.01"],
    ["body_of_water.n.01", "ocean.n.01"],
    ["substance.n.07", "earth.n.02", "sand.n.01"],         # simplified
    ["substance.n.07", "snow.n.01"],                       # simplified
]

# Diamond links (WordNet multiple inheritance) — child → extra parent.
_EXTRA_PARENTS: Dict[str, Tuple[str, ...]] = {
    "person.n.01": ("organism.n.01",),      # person ⊂ organism ∧ causal_agent
    "dog.n.01": ("domestic_animal.n.01",),
    "man.n.01": ("male.n.02",),
    "woman.n.01": ("female.n.02",),
    "baby.n.01": ("juvenile.n.01",),        # simplified placement
}

# Word → synsets (dominant sense(s)). Keep multi-sense entries where the
# second sense matters for answer matching.
LEMMAS: Dict[str, Tuple[str, ...]] = {
    "dog": ("dog.n.01",), "puppy": ("dog.n.01",), "cat": ("cat.n.01",),
    "kitten": ("cat.n.01",), "bear": ("bear.n.01",), "horse": ("horse.n.01",),
    "pony": ("horse.n.01",), "cow": ("cow.n.01",), "cattle": ("cattle.n.01",),
    "sheep": ("sheep.n.01",), "goat": ("goat.n.01",), "pig": ("pig.n.01",),
    "elephant": ("elephant.n.01",), "monkey": ("monkey.n.01",),
    "squirrel": ("squirrel.n.01",), "mouse": ("mouse.n.01",),
    "rabbit": ("rabbit.n.01",), "bunny": ("rabbit.n.01",),
    "bird": ("bird.n.01",), "duck": ("duck.n.01",),
    "chicken": ("chicken.n.02",), "fish": ("fish.n.01",),
    "snake": ("snake.n.01",), "turtle": ("turtle.n.02",),
    "tiger": ("tiger.n.02",), "lion": ("lion.n.01",),
    "giraffe": ("giraffe.n.01",), "animal": ("animal.n.01",),
    "pet": ("domestic_animal.n.01",),
    "person": ("person.n.01",), "man": ("man.n.01",),
    "woman": ("woman.n.01",), "boy": ("boy.n.01",), "girl": ("girl.n.01",),
    "child": ("child.n.01",), "kid": ("child.n.01",),
    "baby": ("baby.n.01",), "infant": ("baby.n.01",),
    "toddler": ("baby.n.01",), "lady": ("lady.n.01",),
    "guy": ("guy.n.01",), "adult": ("adult.n.01",),
    "car": ("car.n.01",), "automobile": ("car.n.01",),
    "truck": ("truck.n.01",), "motorcycle": ("motorcycle.n.01",),
    "motorbike": ("motorcycle.n.01",), "bicycle": ("bicycle.n.01",),
    "bike": ("bicycle.n.01", "motorcycle.n.01"), "cart": ("cart.n.01",),
    "boat": ("boat.n.01",), "ship": ("ship.n.01",),
    "airplane": ("airplane.n.01",), "plane": ("airplane.n.01",),
    "train": ("train.n.01",), "bus": ("bus.n.01",),
    "vehicle": ("vehicle.n.01",),
    "chair": ("chair.n.01",), "sofa": ("sofa.n.01",),
    "couch": ("sofa.n.01",), "bench": ("bench.n.01",),
    "table": ("table.n.02",), "bed": ("bed.n.01",),
    "bottle": ("bottle.n.01",), "cup": ("cup.n.01",), "bowl": ("bowl.n.01",),
    "box": ("box.n.01",), "bag": ("bag.n.01",), "basket": ("basket.n.01",),
    "television": ("television.n.02",), "tv": ("television.n.02",),
    "phone": ("telephone.n.01",), "telephone": ("telephone.n.01",),
    "camera": ("camera.n.01",), "ball": ("ball.n.01",),
    "spoon": ("spoon.n.01",), "fork": ("fork.n.01",),
    "stick": ("stick.n.01",), "guitar": ("guitar.n.01",),
    "drum": ("drum.n.01",), "piano": ("piano.n.01",),
    "book": ("book.n.01",), "toy": ("toy.n.03",), "swing": ("swing.n.02",),
    "hat": ("hat.n.01",), "cap": ("hat.n.01",), "shirt": ("shirt.n.01",),
    "shoe": ("shoe.n.01",), "house": ("house.n.01",),
    "building": ("building.n.01",), "kitchen": ("kitchen.n.01",),
    "bedroom": ("bedroom.n.01",), "bathroom": ("bathroom.n.01",),
    "room": ("room.n.01",), "road": ("road.n.01",),
    "street": ("street.n.01",), "rope": ("rope.n.01",),
    "food": ("food.n.01", "food.n.02"), "dish": ("dish.n.02",),
    "cake": ("cake.n.03",), "apple": ("apple.n.01",),
    "banana": ("banana.n.02",), "orange": ("orange.n.01",),
    "fruit": ("edible_fruit.n.01",), "milk": ("milk.n.01",),
    "juice": ("juice.n.01",), "water": ("water.n.01",),
    "bread": ("bread.n.01",), "beach": ("beach.n.01",),
    "island": ("island.n.01",), "hand": ("hand.n.01",),
    "foot": ("foot.n.01",), "head": ("head.n.01",), "face": ("face.n.01",),
    "hair": ("hair.n.01",), "finger": ("finger.n.01",),
    "leg": ("leg.n.01",), "arm": ("arm.n.01",),
    "lawn": ("lawn.n.01",), "yard": ("yard.n.02",), "park": ("park.n.02",),
    "field": ("field.n.01",), "playground": ("playground.n.02",),
    "floor": ("floor.n.01",), "ground": ("ground.n.01",),
    "tree": ("tree.n.01",), "grass": ("grass.n.01",),
    "flower": ("flower.n.01",), "plant": ("plant.n.02",),
    "pool": ("swimming_pool.n.01",), "stage": ("stage.n.03",),
    "play": ("play.n.01",), "playing": ("play.n.01",),
    "game": ("game.n.01",), "dance": ("dance.n.01",),
    "dancing": ("dance.n.01",), "swimming": ("swimming.n.01",),
    "walk": ("walk.n.05",), "walking": ("walk.n.05",),
    "run": ("run.n.07",), "running": ("run.n.07",),
    "jump": ("jump.n.06",), "jumping": ("jump.n.06",),
    "color": ("color.n.01",), "colour": ("color.n.01",),
    "gesture": ("gesture.n.02",),
    # round-3 widening
    "eat": ("eating.n.01",), "eating": ("eating.n.01",),
    "drink": ("drinking.n.01",), "drinking": ("drinking.n.01",),
    "sit": ("sitting.n.01",), "sitting": ("sitting.n.01",),
    "stand": ("standing.n.03",), "standing": ("standing.n.03",),
    "cry": ("crying.n.02",), "crying": ("crying.n.02",),
    "laugh": ("laughter.n.01",), "laughing": ("laughter.n.01",),
    "laughter": ("laughter.n.01",),
    "smile": ("smile.n.01",), "smiling": ("smile.n.01",),
    "talk": ("conversation.n.01",), "talking": ("conversation.n.01",),
    "conversation": ("conversation.n.01",),
    "sing": ("singing.n.01",), "singing": ("singing.n.01",),
    "music": ("music.n.01",),
    "football": ("football.n.01",), "soccer": ("soccer.n.01",),
    "basketball": ("basketball.n.01",), "tennis": ("tennis.n.01",),
    "sport": ("sport.n.01",), "riding": ("riding.n.01",),
    "ride": ("riding.n.01",),
    "umbrella": ("umbrella.n.01",), "helmet": ("helmet.n.02",),
    "balloon": ("balloon.n.02",), "kite": ("kite.n.03",),
    "skateboard": ("skateboard.n.01",), "scooter": ("scooter.n.02",),
    "stroller": ("baby_buggy.n.01",), "pram": ("baby_buggy.n.01",),
    "door": ("door.n.01",), "fence": ("fence.n.01",),
    "wall": ("wall.n.01",), "window": ("window.n.01",),
    "stairs": ("stairway.n.01",), "staircase": ("stairway.n.01",),
    "mirror": ("mirror.n.01",), "lamp": ("lamp.n.01",),
    "light": ("lamp.n.01",),
    "computer": ("computer.n.01",), "laptop": ("laptop.n.01",),
    "microphone": ("microphone.n.01",), "mic": ("microphone.n.01",),
    "refrigerator": ("refrigerator.n.01",),
    "fridge": ("refrigerator.n.01",), "microwave": ("microwave.n.02",),
    "curtain": ("curtain.n.01",), "blanket": ("blanket.n.01",),
    "pillow": ("pillow.n.01",), "glass": ("glass.n.02",),
    "plate": ("plate.n.04",), "knife": ("knife.n.01",),
    "ladder": ("ladder.n.01",), "tent": ("tent.n.01",),
    "glasses": ("spectacles.n.01",), "spectacles": ("spectacles.n.01",),
    "towel": ("towel.n.01",),
    "dress": ("dress.n.01",), "jacket": ("jacket.n.01",),
    "coat": ("coat.n.01",), "pants": ("trouser.n.01",),
    "trousers": ("trouser.n.01",),
    "rock": ("rock.n.02",), "stone": ("rock.n.02",),
    "sun": ("sun.n.01",), "moon": ("moon.n.01",), "sky": ("sky.n.01",),
    "mountain": ("mountain.n.01",), "valley": ("valley.n.01",),
    "river": ("river.n.01",), "lake": ("lake.n.01",),
    "sea": ("sea.n.01",), "ocean": ("ocean.n.01",),
    "sand": ("sand.n.01",), "snow": ("snow.n.01",),
}


def _build_parents() -> Dict[str, Tuple[str, ...]]:
    parents: Dict[str, set] = {}
    for chain in _CHAINS:
        for child, parent in zip(chain[1:], chain[:-1]):
            parents.setdefault(child, set()).add(parent)
        parents.setdefault(chain[0], set())
    for child, extra in _EXTRA_PARENTS.items():
        parents.setdefault(child, set()).update(extra)
    return {k: tuple(sorted(v)) for k, v in parents.items()}


PARENTS: Dict[str, Tuple[str, ...]] = _build_parents()
ROOT = "entity.n.01"


@functools.lru_cache(maxsize=None)
def max_depth(synset: str) -> int:
    """Longest hypernym path length to the root (root depth 0) — NLTK's
    Synset.max_depth over a multiple-inheritance DAG."""
    ps = PARENTS.get(synset, ())
    if not ps:
        return 0
    return 1 + max(max_depth(p) for p in ps)


@functools.lru_cache(maxsize=None)
def min_depth(synset: str) -> int:
    ps = PARENTS.get(synset, ())
    if not ps:
        return 0
    return 1 + min(min_depth(p) for p in ps)


@functools.lru_cache(maxsize=None)
def _ancestor_dists(synset: str) -> Dict[str, int]:
    """{ancestor (incl. self): shortest hop distance}."""
    out = {synset: 0}
    frontier = [(synset, 0)]
    while frontier:
        node, d = frontier.pop()
        for p in PARENTS.get(node, ()):
            if p not in out or out[p] > d + 1:
                out[p] = d + 1
                frontier.append((p, d + 1))
    return out


def wup(s1: str, s2: str) -> Optional[float]:
    """NLTK-equivalent wup_similarity for two synset names; None if either
    is outside the vendored graph."""
    if s1 not in PARENTS or s2 not in PARENTS:
        return None
    a1, a2 = _ancestor_dists(s1), _ancestor_dists(s2)
    common = set(a1) & set(a2)
    if not common:
        return None
    # lowest_common_hypernyms(use_min_depth=True): maximize min_depth
    best_md = max(min_depth(c) for c in common)
    subsumers = [c for c in common if min_depth(c) == best_md]
    # NLTK then takes subsumers[0]; depth/dist are equal across ties here
    depth = max(max_depth(c) for c in subsumers) + 1
    sub = max(subsumers, key=max_depth)
    len1 = a1[sub] + depth
    len2 = a2[sub] + depth
    return 2.0 * depth / (len1 + len2)


def synsets(word: str) -> Tuple[str, ...]:
    return LEMMAS.get(word.lower().strip(), ())


def word_similarity(a: str, b: str) -> Optional[float]:
    """Max Wu-Palmer over encoded sense pairs; None when either word is
    not in the vendored vocabulary (caller falls back to exact match)."""
    sa, sb = synsets(a), synsets(b)
    if not sa or not sb:
        return None
    best = 0.0
    for x, y in itertools.product(sa, sb):
        s = wup(x, y)
        if s is not None and s > best:
            best = s
    return best


def vocabulary() -> Tuple[str, ...]:
    return tuple(sorted(LEMMAS))
