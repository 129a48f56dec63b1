// TutorialManagement.tsx (615 LoC): gold-task administration — stats
// tiles (tutorial vs validation counts, difficulty distribution),
// all/tutorial/validation filter, task cards with the 7-point answer
// label and difficulty color, create + edit modals with a clickable
// video picker (A/B slots with frame thumbnails), auto-generation from
// Elo extremes.
import {api, h, main, esc, short, toast, USER} from "/static/app.js";

const DIFF_COLOR = {easy: "var(--ok)", medium: "var(--warn)",
                    hard: "var(--bad)"};
// tsx:148-153 answer label from (winner, degree)
const answerLabel = (winner, degree) => {
  if (winner === 0) return "Equal / cannot decide";
  const dir = winner === 1 ? "A" : "B";
  const intensity = degree === 3 ? "much more" : degree === 2 ? "more"
    : "slightly more";
  return `${dir} ${intensity} lame`;
};

export default async function TutorialManagement() {
  const [tasks, stats] = await Promise.all([
    api("/api/tutorial/tasks").then(r => r.tasks),
    api("/api/tutorial/stats").catch(() => null)]);
  const privileged = USER && ["admin", "researcher"].includes(USER.role);
  let filter = "all";

  main.append(h(`<div class="panel"><h2>Tutorial management
      <span class="dim">tutorial examples and validation gold tasks for
      rater training</span>
      ${privileged ? `<button class="mini" id="tm-auto">auto-generate
        </button>
        <button class="action" id="tm-new">+ create task</button>` : ""}</h2>
    ${stats ? `<div class="grid" style="grid-template-columns:repeat(3,1fr)">
      <div class="panel" style="text-align:center">
        <div class="stat">${stats.tutorials.active}<span class="dim"
          style="font-size:14px">/${stats.tutorials.total}</span></div>
        <div class="dim">active tutorials</div></div>
      <div class="panel" style="text-align:center">
        <div class="stat">${stats.gold_tasks.active}<span class="dim"
          style="font-size:14px">/${stats.gold_tasks.total}</span></div>
        <div class="dim">active gold tasks</div></div>
      <div class="panel" style="text-align:center">
        <div class="row" style="justify-content:center">
          ${["easy", "medium", "hard"].map(d => `<span class="badge"
            style="color:${DIFF_COLOR[d]}">${d}:
            ${stats.difficulty_distribution[d] || 0}</span>`).join("")}
        </div><div class="dim">difficulty distribution</div></div></div>`
      : ""}
    <div class="row" style="margin:6px 0" id="tm-filter">
      <button class="mini" data-f="all">all (${tasks.length})</button>
      <button class="mini" data-f="tutorial">tutorials
        (${tasks.filter(t => t.is_tutorial).length})</button>
      <button class="mini" data-f="validation">validation
        (${tasks.filter(t => !t.is_tutorial).length})</button></div>
    <div id="tm-list" class="grid3"></div></div>
  <div id="tm-modal"></div>`));

  const list = document.getElementById("tm-list");
  const modal = document.getElementById("tm-modal");
  const filterBar = document.getElementById("tm-filter");
  [...filterBar.children].forEach(b => b.onclick = () => {
    filter = b.dataset.f; render();
  });

  const render = () => {
    [...filterBar.children].forEach(b =>
      b.style.outline = b.dataset.f === filter ? "2px solid var(--accent)"
        : "");
    const rows = tasks.filter(t => filter === "all"
      || (filter === "tutorial" ? t.is_tutorial : !t.is_tutorial));
    list.innerHTML = "";
    if (!rows.length) {
      list.append(h(`<span class="dim">no tasks in this category</span>`));
      return;
    }
    rows.forEach(t => {
      const card = h(`<div class="panel" style="${t.is_active ? ""
          : "opacity:.55"}">
        <div class="row" style="justify-content:space-between">
          <b>${t.is_tutorial ? "📖 tutorial" : "🥇 validation"}
            ${t.is_tutorial && t.tutorial_order != null
              ? `<span class="dim">#${t.tutorial_order}</span>` : ""}</b>
          <span class="badge" style="color:${DIFF_COLOR[t.difficulty]
            || "var(--dim)"}">${esc(t.difficulty)}</span></div>
        <div class="row" style="margin:4px 0">
          <span class="dim">A ${short(t.video_id_1, 10)}</span>
          <span class="dim">vs</span>
          <span class="dim">B ${short(t.video_id_2, 10)}</span></div>
        <div>answer: <b>${answerLabel(t.correct_winner,
          t.correct_degree)}</b></div>
        ${t.hint ? `<div class="dim" style="font-size:12px">hint:
          ${esc(t.hint)}</div>` : ""}
        ${t.description ? `<div class="dim" style="font-size:12px">${
          esc(t.description)}</div>` : ""}
        ${privileged ? `<div class="row" style="margin-top:6px">
          <button class="mini" data-edit="${t.id}">edit</button>
          <button class="mini bad" data-del="${t.id}">delete</button>
          <button class="mini" data-try="${t.video_id_1}"
            data-try2="${t.video_id_2}">preview pair</button></div>` : ""}
        </div>`);
      list.append(card);
    });
    list.querySelectorAll("[data-del]").forEach(b => b.onclick = async () => {
      try {
        await api(`/api/tutorial/tasks/${b.dataset.del}`,
                  {method: "DELETE"});
        toast("deactivated"); go("tutorial");
      } catch (e) { toast(e.message, "bad"); }
    });
    list.querySelectorAll("[data-edit]").forEach(b => b.onclick = () =>
      openForm(tasks.find(t => t.id === b.dataset.edit)));
    list.querySelectorAll("[data-try]").forEach(b => b.onclick = () =>
      go("pairwise", b.dataset.try, b.dataset.try2));
  };
  render();

  // ---- create / edit modal (tsx:330-560) ---------------------------------
  async function openForm(existing) {
    const videos = existing ? [] : await api("/api/videos?limit=60")
      .then(r => r.videos).catch(() => []);
    const form = {
      video_id_1: existing?.video_id_1 || null,
      video_id_2: existing?.video_id_2 || null,
      correct_winner: existing?.correct_winner ?? 1,
      correct_degree: existing?.correct_degree ?? 2,
      difficulty: existing?.difficulty || "medium",
      hint: existing?.hint || "",
      description: existing?.description || "",
      is_tutorial: !!existing?.is_tutorial,
      tutorial_order: existing?.tutorial_order ?? null,
    };
    const answerOptions = [[1, 3], [1, 2], [1, 1], [0, 0], [2, 1], [2, 2],
                           [2, 3]].map(([w, d]) =>
      `<option value="${w}:${d}" ${form.correct_winner === w &&
        (w === 0 || form.correct_degree === d) ? "selected" : ""}>${
        answerLabel(w, d)}</option>`).join("");
    modal.innerHTML = "";
    modal.append(h(`<div style="position:fixed;inset:0;z-index:70;
        background:rgba(0,0,0,.5);display:flex;align-items:center;
        justify-content:center" id="tm-form-bg">
      <div class="panel" style="max-width:680px;width:94%;max-height:88vh;
          overflow:auto">
        <h2>${existing ? "Edit" : "Create"} gold task</h2>
        ${existing ? `<div class="dim">pair: ${short(form.video_id_1, 12)}
            vs ${short(form.video_id_2, 12)}</div>`
          : `<div class="row">
            <div class="panel" style="flex:1;text-align:center"
              id="tm-slot-a"><b>Video A</b>
              <div class="dim" id="tm-slot-a-v">click a video below</div>
            </div>
            <div class="panel" style="flex:1;text-align:center"
              id="tm-slot-b"><b>Video B</b>
              <div class="dim" id="tm-slot-b-v">then a second one</div>
            </div></div>
          <div id="tm-vids" class="row" style="flex-wrap:wrap;gap:6px;
            max-height:160px;overflow:auto;margin:6px 0"></div>`}
        <div class="row" style="margin-top:6px;flex-wrap:wrap">
          <label>correct answer <select id="tm-answer">${answerOptions}
            </select></label>
          <label>difficulty <select id="tm-diff">
            ${["easy", "medium", "hard"].map(d => `<option ${
              form.difficulty === d ? "selected" : ""}>${d}</option>`)
              .join("")}</select></label>
          <label><input type="checkbox" id="tm-tut"
            ${form.is_tutorial ? "checked" : ""}> tutorial example</label>
          <label>order <input type="number" id="tm-order" style="width:64px"
            value="${form.tutorial_order ?? ""}"></label></div>
        <label class="dim">hint shown to raters</label>
        <input id="tm-hint" value="${esc(form.hint)}" style="width:100%;
          margin-bottom:6px">
        <label class="dim">explanation / description</label>
        <textarea id="tm-desc" rows="2" style="width:100%">${
          esc(form.description)}</textarea>
        <div class="row" style="margin-top:10px">
          <button class="action" style="flex:1" id="tm-save">${existing
            ? "save changes" : "create task"}</button>
          <button class="mini" style="flex:1" id="tm-cancel">cancel</button>
        </div></div></div>`));
    const close = () => modal.innerHTML = "";
    document.getElementById("tm-cancel").onclick = close;
    document.getElementById("tm-form-bg").onclick = (e) => {
      if (e.target.id === "tm-form-bg") close();
    };
    if (!existing) {
      const vidsEl = document.getElementById("tm-vids");
      videos.forEach(v => {
        const chip = h(`<div style="cursor:pointer;text-align:center">
          <img src="/api/videos/${v.id}/frame?frame=0" style="width:84px;
            height:48px;object-fit:cover;border-radius:4px;
            background:var(--line)" loading="lazy">
          <div class="dim" style="font-size:10px">${short(v.id, 8)}</div>
          </div>`);
        chip.onclick = () => {
          if (!form.video_id_1 || (form.video_id_1 && form.video_id_2)) {
            form.video_id_1 = v.id; form.video_id_2 = null;
          } else if (v.id !== form.video_id_1) {
            form.video_id_2 = v.id;
          }
          document.getElementById("tm-slot-a-v").textContent =
            form.video_id_1 ? short(form.video_id_1, 12) : "—";
          document.getElementById("tm-slot-b-v").textContent =
            form.video_id_2 ? short(form.video_id_2, 12) : "—";
        };
        vidsEl.append(chip);
      });
    }
    document.getElementById("tm-save").onclick = async () => {
      const [w, d] = document.getElementById("tm-answer").value
        .split(":").map(Number);
      const body = {
        correct_winner: w, correct_degree: d || 2,
        difficulty: document.getElementById("tm-diff").value,
        hint: document.getElementById("tm-hint").value || null,
        description: document.getElementById("tm-desc").value || null,
        is_tutorial: document.getElementById("tm-tut").checked ? 1 : 0,
        tutorial_order: document.getElementById("tm-order").value
          ? +document.getElementById("tm-order").value : null,
      };
      try {
        if (existing) {
          await api(`/api/tutorial/tasks/${existing.id}`,
                    {method: "PUT", json: body});
          toast("task updated");
        } else {
          if (!form.video_id_1 || !form.video_id_2)
            return toast("pick two videos first", "warn");
          await api("/api/tutorial/tasks", {json: {
            video_id_1: form.video_id_1, video_id_2: form.video_id_2,
            ...body}});
          toast("task created");
        }
        close(); go("tutorial");
      } catch (e) { toast(e.message, "bad"); }
    };
  }

  const newBtn = document.getElementById("tm-new");
  if (newBtn) newBtn.onclick = () => openForm(null);
  const auto = document.getElementById("tm-auto");
  if (auto) auto.onclick = async () => {
    try {
      const r = await api("/api/tutorial/auto-generate", {json: {count: 3}});
      toast(`created ${(r.created_ids || r.created || []).length} tasks `
        + `from Elo extremes`);
      go("tutorial");
    } catch (e) { toast(e.message, "bad"); }
  };
}
