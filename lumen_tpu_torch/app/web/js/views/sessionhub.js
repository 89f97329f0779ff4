// SessionHub view (reference: web-ui/src/views/SessionHub.tsx): given the
// opened config, offline-check the deployment (models present in the
// cache?) and route to the recommended action — start the server as-is,
// run the installer, or fix the config. First-class route like the
// reference's /session; the status comes from POST /api/v1/session/status.

import { api } from "../api.js";
import { wizard } from "../wizard.js";
import { el } from "../ui.js";

export function renderSessionHub(root) {
  const configPath = wizard.state.configPath;
  root.append(
    el("div", { class: "hero" }, [
      el("h1", {}, "Session hub"),
      el("p", { class: "muted", id: "hub-path" }, configPath ? `config: ${configPath}` : "no config opened"),
    ]),
    el("div", { class: "row" }, [
      el("button", { class: "btn ghost", id: "hub-switch" }, "← Switch path"),
    ]),
    el("div", { id: "hub-status", class: "card" }, [
      el("p", { class: "muted" }, "checking deployment…"),
    ])
  );
  root.querySelector("#hub-switch").onclick = () => wizard.goto("openpath");

  const box = root.querySelector("#hub-status");
  if (!configPath) {
    box.replaceChildren(
      el("p", { class: "warn-note" }, "no config opened — validate a path first"),
      actionRow([goBtn("openpath", "Open a config →")])
    );
    return;
  }
  renderStatus(box, configPath);
}

async function renderStatus(box, configPath) {
  let s;
  try {
    s = await api.sessionStatus(configPath);
  } catch (e) {
    if (!box.isConnected) return;
    box.replaceChildren(
      el("p", { class: "err-note" }, `could not check the deployment: ${e.message}`),
      actionRow([goBtn("openpath", "← Back to path")])
    );
    return;
  }
  if (!box.isConnected) return;

  const children = [];
  if (s.ready_to_start) {
    children.push(el("p", { class: "ok-note" }, `✓ ${s.message}`));
  } else {
    children.push(el("p", { class: "warn-note" }, `⚠ ${s.message}`));
  }
  if (s.models && s.models.length) {
    children.push(
      el(
        "ul",
        { class: "steplist" },
        s.models.map((m) =>
          el("li", { class: m.present ? "passed" : "failed" }, [
            el("span", { class: "step-ico" }, m.present ? "✓" : "✕"),
            `${m.service}/${m.alias}: ${m.model}`,
            m.present ? "" : el("span", { class: "step-detail" }, m.error || "missing"),
          ])
        )
      )
    );
  }
  // recommended_action: start_existing | run_install | open_config —
  // primary button follows the recommendation, alternatives stay ghost.
  const rec = s.recommended_action;
  const actions = [
    goBtn("server", "Start / manage server →", rec === "start_existing"),
    goBtn("install", "Run installer →", rec === "run_install"),
    goBtn("config", "Open config →", rec === "open_config"),
  ];
  children.push(actionRow(actions));
  box.replaceChildren(...children);
}

function goBtn(step, label, primary = false) {
  const btn = el("button", { class: primary ? "btn primary" : "btn ghost" }, label);
  // Direct jump, not wizard.goto(): the hub routes on the deployment's
  // actual state (models present), which outranks the linear setup gate —
  // e.g. "start_existing" goes straight to Server with no install step.
  btn.onclick = () => wizard.update({ step });
  return btn;
}

function actionRow(buttons) {
  return el("div", { class: "row" }, buttons);
}
