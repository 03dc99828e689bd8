"""Scheduling priority policies (reference: qserve/core/policy.py)."""

from __future__ import annotations

from typing import Deque, List

from qserve_tpu_torch.sequence import SequenceGroup


class Policy:
    def get_priority(self, now: float, seq_group: SequenceGroup) -> float:
        raise NotImplementedError

    def sort_by_priority(
        self, now: float, seq_groups: Deque[SequenceGroup]
    ) -> List[SequenceGroup]:
        return sorted(
            seq_groups, key=lambda g: self.get_priority(now, g), reverse=True
        )


class FCFS(Policy):
    def get_priority(self, now: float, seq_group: SequenceGroup) -> float:
        return now - seq_group.arrival_time


class PolicyFactory:
    _registry = {"fcfs": FCFS}

    @classmethod
    def get_policy(cls, name: str) -> Policy:
        return cls._registry[name]()
